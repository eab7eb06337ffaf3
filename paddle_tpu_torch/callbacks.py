"""paddle.callbacks parity: the hapi callbacks (``hapi.callbacks``)."""
from .hapi.callbacks import (Callback, EarlyStopping,  # noqa: F401
                             LRScheduler, ModelCheckpoint, ProgBarLogger,
                             ReduceLROnPlateau, VisualDL, WandbCallback)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau",
           "WandbCallback"]

"""The static layer functions' ``act`` strings (``paddle_tpu/static/
nn_shim.py``)."""


def apply_act(x, act):
    if act is None:
        return x
    from ..nn import functional as F
    return getattr(F, act)(x)

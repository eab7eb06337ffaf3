"""Default-device resolution for the port's entry points.

The port exists to run on an NVIDIA card, so ``device=None`` means
``"cuda"``. A missing card is an error, never a quiet fall back to the
CPU: a caller that wants the plain PyTorch versions (the CPU tests)
asks for ``device="cpu"`` explicitly.
"""
import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` (None, a string or a ``torch.device``) as a
    ``torch.device``; None resolves to ``"cuda"``. Raises RuntimeError
    when a CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return dev

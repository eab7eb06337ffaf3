"""Device resolution for the port's entry points, and the tensor API's
default place.

The port exists to run on an NVIDIA card, so ``device=None`` means
``"cuda"``. A missing card is an error, never a quiet fall back to the
CPU: a caller that wants the plain PyTorch versions (the CPU tests)
asks for ``device="cpu"`` explicitly.

The paddle API (``to_tensor``, the creation ops) makes its tensors on
the default place: the card until ``set_device("cpu")`` (or a
``place=`` of ``"cpu"`` / ``CPUPlace()``) says otherwise. Without a
card the default raises, as ``resolve_device`` does.
"""
import contextlib

import torch

__all__ = ["resolve_device", "set_device", "get_device", "default_device",
           "default_place", "place_to_device", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace"]


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


class CPUPlace:
    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace:
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"Place(gpu:{self.device_id})"


class CUDAPinnedPlace:
    def __repr__(self):
        return "Place(gpu_pinned)"


_default = [None]   # the tensor API's place; None: the card


def place_to_device(place):
    """A paddle place (None, ``"cpu"``, ``"gpu"``, ``"gpu:1"``,
    ``CPUPlace()``, ``CUDAPlace(i)``, ``"cuda"`` or a ``torch.device``)
    as a ``torch.device``; None stays None (the default place)."""
    if place is None:
        return None
    if isinstance(place, (CPUPlace, CUDAPinnedPlace)):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        return resolve_device(f"cuda:{place.device_id}")
    if isinstance(place, str):
        place = place.replace("gpu", "cuda")
    return resolve_device(place)


def default_device():
    """The default place as a ``torch.device``: the card (raising
    without one) unless ``set_device`` chose another."""
    dev = _default[0]
    return resolve_device() if dev is None else dev


def set_device(device):
    """paddle.set_device: ``"cpu"``, ``"gpu"`` or ``"gpu:N"`` becomes the
    default place of ``to_tensor`` and the creation ops. Returns the
    device as a ``torch.device``."""
    dev = place_to_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    _default[0] = dev
    return dev


def get_device():
    """``"cpu"`` or ``"gpu:N"``, the default place in paddle's words."""
    dev = default_device()
    if dev.type == "cpu":
        return "cpu"
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    return f"gpu:{idx}"


@contextlib.contextmanager
def default_place(device=None):
    """Inside the block the default place is ``device`` (a paddle place or
    a torch device); None leaves it as it is. The models built from
    ``nn``'s layers take their ``device=`` keyword so."""
    if device is None:
        yield
        return
    before = _default[0]
    _default[0] = place_to_device(device)
    try:
        yield
    finally:
        _default[0] = before

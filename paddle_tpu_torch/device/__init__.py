"""Device resolution for the port's entry points, the tensor API's
default place, and ``paddle.device``.

The port exists to run on an NVIDIA card, so ``device=None`` means
``"cuda"``. A missing card is an error, never a quiet fall back to the
CPU: a caller that wants the plain PyTorch versions (the CPU tests)
asks for ``device="cpu"`` explicitly.

The paddle API (``to_tensor``, the creation ops) makes its tensors on
the default place: the card until ``set_device("cpu")`` (or a
``place=`` of ``"cpu"`` / ``CPUPlace()``) says otherwise. Without a
card the default raises, as ``resolve_device`` does.

The rest is the port of ``paddle_tpu/device/__init__.py``, mapped onto
torch's CUDA runtime: ``Stream`` / ``Event`` / ``current_stream`` /
``set_stream`` / ``stream_guard`` over ``torch.cuda.Stream`` /
``Event`` / ``torch.cuda.stream``, ``synchronize``, ``device_count``,
``memory_stats`` (the reference's keys ``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``, from torch's allocator) and the
``cuda`` namespace. On the CPU place the streams and events keep the
reference's barrier semantics (the reference's XLA orders work itself)
and ``memory_stats`` is ``{}``; without a card and without the CPU place
they raise. ``cuda.is_available``, ``is_compiled_with_cuda``,
``get_cudnn_version``, ``get_all_device_type`` and
``is_compiled_with_custom_device`` describe this card, not the
reference's TPU build.
"""
import contextlib

import torch

__all__ = ["resolve_device", "set_device", "get_device", "default_device",
           "default_place", "place_to_device", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "get_all_device_type", "get_available_device",
           "is_compiled_with_cinn", "cuda", "Stream", "Event",
           "synchronize", "device_count", "memory_stats"]


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


# ------------------------------------------------ paddle.device on torch


def _place(device=None):
    """``device`` (a paddle place or None: the default place) as a
    ``torch.device``; raises without a card unless it is the CPU."""
    return default_device() if device is None else place_to_device(device)


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_available_device():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"gpu:{i}" for i in range(n)] or ["cpu"]


def get_all_custom_device_type():
    return []


def is_compiled_with_cinn():
    return False


def device_count():
    return torch.cuda.device_count()


def synchronize(device=None):
    """Wait for the card's work (``torch.cuda.synchronize``); nothing to
    wait for on the CPU place."""
    dev = _place(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_stats(device=None):
    """The reference's allocator keys for the card: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (torch's allocated bytes, current and peak, as
    ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` give them)
    and ``bytes_limit`` (the card's total memory); ``{}`` on the CPU
    place, as the reference's CPU device gives."""
    dev = _place(device)
    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": st.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(dev)[1]}


class Stream:
    """A CUDA stream on the card (``torch.cuda.Stream``; ``priority`` 1
    is high, 2 normal, as paddle's); on the CPU place the reference's
    barrier: work is ordered already, the waits return at once."""

    def __init__(self, device=None, priority=2, stream=None):
        dev = _place(device)
        self.device = dev
        if stream is not None:
            self._s = stream
        elif dev.type == "cuda":
            self._s = torch.cuda.Stream(dev, priority=-1 if priority == 1
                                        else 0)
        else:
            self._s = None

    @property
    def cuda_stream(self):
        return self._s.cuda_stream if self._s is not None else 0

    def synchronize(self):
        if self._s is not None:
            self._s.synchronize()

    def query(self):
        return True if self._s is None else self._s.query()

    def wait_event(self, event):
        if self._s is not None:
            self._s.wait_event(event._e)

    def wait_stream(self, stream):
        if self._s is not None:
            self._s.wait_stream(stream._s)

    def record_event(self, event=None):
        e = event or Event()
        e.record(self)
        return e


class Event:
    """A CUDA event on the card (``torch.cuda.Event``); on the CPU place
    the reference's barrier event: recorded, and always reached."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self._e = (torch.cuda.Event(enable_timing=enable_timing,
                                    blocking=blocking,
                                    interprocess=interprocess)
                   if _place().type == "cuda" else None)
        self._recorded = False

    def record(self, stream=None):
        self._recorded = True
        if self._e is not None:
            self._e.record(None if stream is None else stream._s)

    def query(self):
        return True if self._e is None else self._e.query()

    def synchronize(self):
        if self._e is not None:
            self._e.synchronize()

    def elapsed_time(self, end_event):
        """Milliseconds from this event to ``end_event`` (both recorded
        with ``enable_timing=True``; 0.0 on the CPU place)."""
        if self._e is None:
            return 0.0
        return self._e.elapsed_time(end_event._e)


def current_stream(device=None):
    dev = _place(device)
    if dev.type != "cuda":
        return Stream(dev)
    return Stream(dev, stream=torch.cuda.current_stream(dev))


def set_stream(stream):
    """Make ``stream`` the current stream of its device."""
    if stream._s is not None:
        torch.cuda.set_stream(stream._s)
    return stream


@contextlib.contextmanager
def stream_guard(stream):
    """Inside the block, work is queued on ``stream`` (``torch.cuda.
    stream``); nothing changes on the CPU place."""
    if stream._s is None:
        yield
        return
    with torch.cuda.stream(stream._s):
        yield


class _CudaNamespace:
    """paddle.device.cuda: this card's count, availability and allocator
    statistics."""

    Stream = Stream
    Event = Event

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def is_available():
        return torch.cuda.is_available()

    @staticmethod
    def max_memory_allocated(device=None):
        return memory_stats(device).get("peak_bytes_in_use", 0)

    @staticmethod
    def memory_allocated(device=None):
        return memory_stats(device).get("bytes_in_use", 0)

    @staticmethod
    def empty_cache():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)


cuda = _CudaNamespace()


# ------------------------------------------------ reference device shims


def get_cudnn_version():
    """cuDNN's version on this card's build; None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.backends.cudnn.version()


def is_compiled_with_cuda():
    """True when a CUDA card is there to run on."""
    return torch.cuda.is_available()


def is_compiled_with_rocm():
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_ipu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_mlu():
    return False


def is_compiled_with_custom_device(device_type=None):
    """No custom device: the port runs on CUDA (the reference's TPU build
    answers True for "tpu")."""
    return False


def get_available_custom_device():
    return []


class XPUPlace:
    def __init__(self, device_id=0):
        self.device_id = device_id


class IPUPlace(XPUPlace):
    pass


class MLUPlace(XPUPlace):
    pass

"""Places and the IPU shells of ``paddle.static``: port of
``paddle_tpu/static/device.py``. Places are informational here (the
Executor runs on its ``place``, the default place when None);
``name_scope`` prefixes the names the static API generates."""
import contextlib

import torch

from ..utils import unique_name

__all__ = ["cpu_places", "xpu_places", "cuda_places", "npu_places",
           "mlu_places", "device_guard", "name_scope", "ipu_shard_guard",
           "IpuStrategy", "IpuCompiledProgram", "set_ipu_shard"]


def cpu_places(device_count=None):
    n = device_count or 1
    return [f"cpu:{i}" for i in range(n)]


def xpu_places(device_count=None):
    return cpu_places(device_count)


@contextlib.contextmanager
def device_guard(device=None):
    yield


@contextlib.contextmanager
def name_scope(prefix=None):
    """Prefix generated names with ``prefix``, on the global counters:
    two models built under one prefix never collide in the scope."""
    outer = unique_name._generator

    class _Prefixed(unique_name.UniqueNameGenerator):
        def __call__(self, key):
            return outer(f"{prefix or ''}{key}")

    with unique_name.guard(_Prefixed()):
        yield


def cuda_places(device_ids=None):
    """One place per card named (all visible cards when None): the port
    runs on CUDA cards, where the reference, on a TPU, lists none."""
    ids = device_ids if device_ids is not None else range(
        torch.cuda.device_count())
    return [f"gpu:{i}" for i in ids]


def npu_places(device_ids=None):
    return []


def mlu_places(device_ids=None):
    return []


def ipu_shard_guard(index=-1, stage=-1):
    return contextlib.nullcontext()


class IpuStrategy:
    def __init__(self):
        self.enable_fp16 = False


class IpuCompiledProgram:
    def __init__(self, program=None, ipu_strategy=None, scope=None):
        raise NotImplementedError(
            "the IPU backend is not part of this build; run the program "
            "with static.Executor")


def set_ipu_shard(call_func, index=-1, stage=-1):
    return call_func

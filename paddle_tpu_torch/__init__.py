"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

``paddle_tpu`` (JAX/XLA/Pallas) stays the reference; this package does
the same work in PyTorch on an NVIDIA Hopper card, slice by slice.

The paddle API (``import paddle_tpu_torch as pt``): ``pt.Tensor``,
``pt.Parameter`` and ``pt.to_tensor`` over torch tensors with torch's
autograd (``core.tensor``), the dtypes (``pt.float32`` ... as
``torch.dtype``s, narrowed as the reference's 64-bit-off JAX narrows
them: ``to_tensor(np.arange(3))`` is int32), ``no_grad`` /
``enable_grad`` / ``set_grad_enabled``, ``pt.grad`` and
``pt.autograd`` (``backward``, ``PyLayer``, ``vjp``, ``jvp``,
``jacobian``, ``hessian``), and the flat op namespace: every op of
``ops.registry.OPS`` (creation, math, manipulation, linalg and the
``nn.functional`` ops the reference registers) as ``pt.<name>`` and,
where the reference has one, as a ``Tensor`` method, in-place variants
included. Tensors are made on the default place: the card, unless
``pt.set_device("cpu")`` (or ``place="cpu"``) says otherwise; without a
card the default raises. The random ops (``ops.random_ops``) draw
``jax.random``'s stream under ``pt.seed``, as do ``nn``'s initializers
(``ParamAttr``, ``create_parameter``). The serving tick and the train
step take plain torch tensors and never go through this layer.

What runs on the card:
- Llama serving: ``models.llama.LlamaForCausalLM``, its paged and dense
  decode bundles (``models.generation``), ``generate()`` (greedy,
  seeded sampling, beam search, FSM-constrained), speculative decoding
  (``inference.speculative_generate``), and
  ``inference.ContinuousBatchingServer`` (paged with ragged prefill and
  split or fused ticks, or dense; the radix prefix cache, optimistic
  admission with exact preemption, the supervised serve loop, the host
  KV tier);
- GPT-2 and Mixtral on both servers, weight-only int8 and the dense int8
  KV cache; ``quantization.to_int8_inference``;
- the fleet: ``inference.ReplicaRouter`` over in-process replicas or
  process-isolated ones on the wire (``inference.transport`` /
  ``inference.remote``), live page migration and disaggregated
  prefill/decode; telemetry (``telemetry``: metrics, traces, the flight
  recorder, goodput, costs, journeys, SLOs);
- deployment: ``inference.export_layer`` / ``Predictor`` /
  ``export_decode`` over ``torch.export``, and the ``BatchScheduler``;
- training: ``nn`` (``Layer`` over ``torch.nn.Module`` and its
  containers; ``functional``; the core layers: convolutions, pools,
  norms, dropouts, activations, losses; the RNNs and the Transformer
  stack; the tail: CTC, RNN-T, fold / unfold, unpooling, beam search;
  the initializers; ``nn.utils``; the gradient clips), the model zoo
  (``models``: BERT, DiT, Qwen-VL with its ``generate``; Mixtral's
  ``forward`` / ``loss`` over ``parallel.moe``'s GShard dispatch), the
  optimizer zoo and
  its schedulers, ``amp`` (``auto_cast``, ``decorate``, ``GradScaler``),
  recompute, ``jit.train_step_fn``, and the high-level loop ``Model``
  (``hapi``) with ``io.DataLoader``, checkpoints, ``metric`` and the
  fault-tolerant ``reliability.TrainSupervisor``;
- the host-side framework: ``reader``, ``device`` (streams, events,
  ``memory_stats``), ``utils`` (``cpp_extension``: g++-built host ops),
  ``runtime`` (the FLAGS_ registry behind ``get_flags`` / ``set_flags``,
  ``TCPStore``, ``ShmRing``, which carries ``io.DataLoader``'s native
  ring), ``profiler`` (over ``torch.profiler``), ``cost_model``,
  ``sysconfig``;
- vision (``vision``: ``transforms``, ``datasets``, the model zoo of
  ``models`` — LeNet, VGG, ResNet / ResNeXt / wide, AlexNet, MobileNet
  v1 / v2 / v3, SqueezeNet, DenseNet, GoogLeNet, InceptionV3,
  ShuffleNetV2 — and the detection ``ops``), ``fft``, ``signal`` and
  ``linalg``;
- randomness: ``jax.random``'s threefry stream (``core.prng``,
  ``seed`` / ``get_rng_state`` / ``set_rng_state``): the uniform family
  bit for bit, the normal family within 3 ulps.

Every TPU kernel has a hand-written CUDA counterpart for ``sm_90a``
under ``csrc/``, each with its plain PyTorch version beside it
(``ops.kernels``): paged decode (K1), ragged prefill (K2) and the fused
tick (K3) for serving; flash attention (K4) and RMSNorm (K5), forward
and backward, for training (``nn.functional.flash_attention`` and
``rms_norm``, which take the paddle ``Tensor`` too); rope (K6), the
GEMM epilogue (K7) and the int8 matmul (K8); the optimizer's fused
Adam step; and the random kernels R1 (the serving tick's seeded draw)
and R2 (dropout and the draws: bits, uniform, normal, truncated
normal).

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``). On the CPU every kernel wrapper takes its
plain version; a CUDA tensor takes the kernel or raises.

This package imports torch, numpy and the standard library only — never
jax or ``paddle_tpu`` (tests/test_torch_import_hygiene.py).
"""
import importlib as _importlib

import numpy as _np
import torch as _torch

from . import amp, autograd, core, jit, nn, ops, optimizer  # noqa: F401
from . import hapi, io, metric, reliability  # noqa: F401
from .core import dtype as _dtype_mod
from .core.dtype import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, float16, float32, float64, int8,
    int16, int32, int64, uint8,
)
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.tape import enable_grad, no_grad, set_grad_enabled  # noqa: F401
from .core.tensor import (  # noqa: F401
    Parameter, Tensor, set_nan_inf_check, to_tensor,
)
from .device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, device_count, get_device,
    is_compiled_with_cuda, resolve_device, set_device,
)
from .hapi import Model, flops, summary  # noqa: F401
from .io import load, save  # noqa: F401
from .nn.layer import create_parameter  # noqa: F401
from .nn.param_attr import ParamAttr  # noqa: F401
from .ops import random_ops as _random_ops  # noqa: F401
from .ops.registry import OPS as _OPS
from .ops.registry import install_method_tail as _install_mt
from .ops.registry import install_tensor_methods as _install_tm

__version__ = "0.1.0"       # the JAX package's, whose API this ports

# second pass: nn.functional registered more ops (relu, softmax, ...)
# after ops installed its methods; pick up their in-place variants
_install_tm()
_install_mt()

# every registered op at the top level (paddle.* flat namespace)
_g = globals()
for _name, _op in _OPS.items():
    _g.setdefault(_name, _op)
del _g

# subpackages loaded on first use (the reference's lazy list, where the
# port has the package)
_LAZY = ("parallel", "models", "incubate", "static", "inference",
         "quantization", "telemetry", "regularizer", "callbacks", "utils",
         "runtime", "profiler", "reader", "cost_model", "sysconfig",
         "vision", "fft", "signal", "linalg")


def __getattr__(name):
    if name in _OPS:
        return _OPS[name]
    if name in _LAZY:
        mod = _importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")


def is_compiled_with_xpu():
    return False


def is_compiled_with_tpu():
    return False


_default_dtype = [_dtype_mod.float32]


def get_default_dtype():
    return _default_dtype[0]


def set_default_dtype(d):
    _default_dtype[0] = _dtype_mod.convert_dtype(d)


def disable_static(place=None):
    """``paddle.disable_static``: leave the global static-graph mode."""
    from .static import graph as _g
    _g.disable_static_mode()


def enable_static():
    """``paddle.enable_static``: ops on ``static.data`` Variables record
    into ``static.default_main_program()`` without a ``program_guard``.
    Eager Tensors keep running: only ops on Variables record."""
    from .static import graph as _g
    _g.enable_static_mode()


def in_dynamic_mode():
    """False while ``enable_static`` is in force."""
    from .static import graph as _g
    return not _g.in_static_mode()


def grad(*args, **kwargs):
    return autograd.grad(*args, **kwargs)


def synchronize():
    if _torch.cuda.is_available():
        _torch.cuda.synchronize()


# ------------------------------------------------ top-level parity tail

dtype = _torch.dtype
bool = _dtype_mod.bool_          # noqa: A001 — paddle.bool dtype alias


def iinfo(dt):
    return _torch.iinfo(_dtype_mod.convert_dtype(dt))


def finfo(dt):
    return _torch.finfo(_dtype_mod.convert_dtype(dt))


def is_tensor(x):
    return isinstance(x, Tensor)


def _dt_of(x):
    return _dtype_mod.convert_dtype(x.dtype if hasattr(x, "dtype") else x)


def is_complex(x):
    return _dt_of(x).is_complex


def is_integer(x):
    d = _dt_of(x)
    return not (d.is_floating_point or d.is_complex or d == _torch.bool)


def is_floating_point(x):
    return _dt_of(x).is_floating_point


def rank(x):
    """paddle.rank: a 0-d int32 tensor holding ndim."""
    v = x._value if isinstance(x, Tensor) else x
    return to_tensor(v.dim(), dtype="int32", place=v.device)


def is_grad_enabled():
    return _torch.is_grad_enabled()


def tolist(x):
    return (x.numpy() if isinstance(x, Tensor) else x).tolist()


def floor_mod(x, y):
    return _OPS["mod"](x, y)


def broadcast_shape(x_shape, y_shape):
    return list(_np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def get_cuda_rng_state():
    """The global RNG state (one threefry key, as the reference's)."""
    return [get_rng_state()]


def set_cuda_rng_state(state):
    set_rng_state(state[0] if isinstance(state, (list, tuple)) else state)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def disable_signal_handler():
    pass  # the reference installs no fault handlers either


class LazyGuard:
    """paddle.LazyGuard: parameters are made when a layer is built, so
    the guard changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class NPUPlace(CUDAPlace):
    def __repr__(self):
        return f"Place(npu:{self.device_id})"


class TPUPlace:
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"Place(tpu:{self.device_id})"


def batch(reader, batch_size, drop_last=False):
    """Legacy reader decorator: groups of ``batch_size`` items."""
    def gen():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return gen


def tanh_(x):
    return x.tanh_()


def scatter_(x, index, updates, overwrite=True):
    return x.scatter_(index, updates, overwrite)


def reshape_(x, shape):
    return x.reshape_(shape)


def squeeze_(x, axis=None):
    return x.squeeze_(axis)


def unsqueeze_(x, axis):
    return x.unsqueeze_(axis)


def set_flags(flags):
    """paddle.set_flags: the native registry (``runtime.set_flags``)."""
    from .runtime import set_flags as _sf
    return _sf(flags)


def get_flags(names):
    """paddle.get_flags: the native registry (``runtime.get_flags``)."""
    from .runtime import get_flags as _gf
    return _gf(names)


def check_shape(x, shape):
    """Assert a tensor's shape (-1 or None matches any size)."""
    import builtins
    got = list(x.shape)
    want = list(shape)
    ok = len(got) == len(want) and builtins.all(
        w in (-1, None) or g == w for g, w in zip(got, want))
    if not ok:
        raise ValueError(f"shape mismatch: got {got}, expected {want}")
    return x


def broadcast_tensors(inputs):
    """All of ``inputs`` broadcast to their common shape."""
    target = _np.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [_OPS["broadcast_to"](t, list(target)) for t in inputs]


def index_add_(x, index, axis, value):
    return x.index_add_(index, axis, value)


def index_add(x, index, axis, value):
    return _OPS["index_add"](x, index, axis, value)

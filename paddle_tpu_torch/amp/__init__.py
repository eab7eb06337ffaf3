"""Automatic mixed precision: ``auto_cast``, ``decorate`` and
``GradScaler`` (``paddle.amp``).

Port of ``paddle_tpu/amp/__init__.py``. The reference casts every op's
inputs in its dispatch layer (``core/tensor.py:172``), by the op's name
and its membership of ``WHITE_LIST`` (cast to the AMP dtype) or
``BLACK_LIST`` (cast to f32); an op on neither list is left alone. The
port has no dispatch layer: each ``nn.functional`` entry point that the
Llama train step reaches calls ``cast_inputs_for_op`` under the
reference's op name (``linear``, ``flash_attention``, ``sdp_attention``
white; ``rms_norm``, ``softmax``, ``cross_entropy_with_softmax``,
``cross_entropy_soft`` black). The lists and the rule are the
reference's: floating tensors of one dimension or more are cast, others
(integer labels, scalars, None) pass.

``decorate`` casts parameters only, as the reference's ``Layer.astype``
does: buffers (the Llama rope tables) stay f32, where
``nn.Module.to(dtype)`` would cast them too. ``GradScaler`` unscales all
gradients in one multi-tensor pass with one finiteness flag and one host
read a step (``torch._amp_foreach_non_finite_check_and_unscale_``, one
call a gradient type), as the reference's ``_fused_unscale`` does.
"""
import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "white_list", "black_list", "amp_state", "cast_inputs_for_op",
           "WHITE_LIST", "BLACK_LIST"]

# reference lists: python/paddle/amp/auto_cast.py WHITE_LIST/BLACK_LIST
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "flash_attention", "sdp_attention",
}
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cos_sim",
    "softmax", "log_softmax", "cross_entropy_with_softmax", "cross_entropy_soft",
    "layer_norm", "rms_norm", "batch_norm", "group_norm", "instance_norm",
    "logsumexp", "norm", "cumsum", "cumprod", "var", "std", "erf", "erfinv",
    "pow", "reciprocal", "rsqrt", "sqrt",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_state = threading.local()


def _dtype(d):
    return _DTYPES[d] if isinstance(d, str) else d


class AmpState:
    __slots__ = ("enabled", "dtype", "level", "white", "black")

    def __init__(self, enabled=False, dtype=torch.bfloat16, level="O1",
                 white=None, black=None):
        self.enabled = enabled
        self.dtype = dtype
        self.level = level
        self.white = white or WHITE_LIST
        self.black = black or BLACK_LIST


def amp_state():
    """This thread's AMP state (disabled outside ``auto_cast``)."""
    st = getattr(_state, "amp", None)
    if st is None:
        st = AmpState()
        _state.amp = st
    return st


def white_list():
    return amp_state().white


def black_list():
    return amp_state().black


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Inside the block, ops on the white list run in ``dtype`` and ops
    on the black list in f32 (``cast_inputs_for_op``). O1 and O2 cast
    alike, as in the reference; O2 differs by the parameters
    ``decorate`` casts."""
    prev = getattr(_state, "amp", None)
    white = set(WHITE_LIST)
    black = set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    _state.amp = AmpState(enable, _dtype(dtype), level, white, black)
    try:
        yield
    finally:
        _state.amp = prev


amp_guard = auto_cast


def cast_inputs_for_op(op_name, tensors, st=None):
    """``tensors`` cast by the O1 rule for the op ``op_name``: to the AMP
    dtype for a white-listed op, to f32 for a black-listed one; floating
    tensors of one dimension or more only. Unchanged when AMP is off or
    the op is on neither list."""
    st = amp_state() if st is None else st
    if not st.enabled:
        return tensors
    if op_name in st.white:
        target = st.dtype
    elif op_name in st.black:
        target = torch.float32
    else:
        return tensors
    return [t.to(target) if isinstance(t, torch.Tensor)
            and t.is_floating_point() and t.dtype != target and t.dim() > 0
            else t for t in tensors]


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Cast every floating parameter of ``models`` (a module or a list)
    to ``dtype`` in place (``paddle.amp.decorate``; the reference casts
    at every level). Buffers keep their dtype. An optimizer keeps its
    references: the parameters are the same objects."""
    d = _dtype(dtype)
    for m in (models if isinstance(models, (list, tuple)) else [models]):
        for p in m.parameters():
            if p.is_floating_point() and p.dtype != d:
                p.data = p.data.to(d)
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = d
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (reference ``grad_scaler.py:38``): the loss
    scaled by ``scale``, the gradients unscaled before the step, a step
    with a non-finite gradient skipped, the scale grown after
    ``incr_every_n_steps`` good steps and shrunk after
    ``decr_every_n_nan_or_inf`` bad ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = set()  # id(optimizer) already unscaled this step

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Every gradient of ``optimizer`` times ``1 / scale`` (in the
        gradient's type, as the reference casts the inverse to it), and
        one finiteness flag read once. A second call before the step does
        nothing."""
        if not self._enable:
            return
        if id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        grads = [p.grad for p in optimizer._parameters if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        dev = grads[0].device
        inv = torch.tensor(1.0 / self._scale, dtype=torch.float32)
        found = torch.zeros((), dtype=torch.float32, device=dev)
        by_type = {}
        for g in grads:
            by_type.setdefault(g.dtype, []).append(g)
        for dt, gs in by_type.items():
            # the reference multiplies by inv cast to the gradient's type
            torch._amp_foreach_non_finite_check_and_unscale_(
                gs, found, inv.to(dt).float().to(dev))
        self._found_inf = bool(found.item())

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled.discard(id(optimizer))

    def update(self):
        self._unscaled.clear()
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)

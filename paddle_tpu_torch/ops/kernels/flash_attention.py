"""Flash attention forward and backward (K4a, K4b): CUDA kernels, plain
versions and the autograd Functions.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``. The forward returns
o and the row logsumexp; the backward is FlashAttention-2's: ``delta =
rowsum(do * o)`` (minus the lse cotangent, when lse is an output that
feeds a loss), ``p = exp(s - lse)``, ``ds = p * (dp - delta)``, from the
saved o and lse.

Causal masking aligns the diagonal TOP-LEFT (query row i sees keys
0..i, whatever the lengths), as the Pallas kernels do. The JAX
package's XLA reference ``_ref_with_lse`` aligns it bottom-right, so the
two JAX routes disagree when ``S_q != S_k``; the port's kernel and its
plain version both follow the TPU kernel (ROADMAP, Queue 3). With
``S_q == S_k``, as in training, all of them agree.

``flash_fwd``, ``flash_bwd`` launch the hand-written kernels
(``csrc/flash_attention.cu``: forward, dq, dk + dv) for CUDA tensors and
the plain versions ``_ref_with_lse``/``_ref_bwd`` for CPU tensors; a
CUDA tensor the kernels cannot take raises instead of falling back.
``flash_fwd.launches`` counts forward launches, ``flash_bwd.dq_launches``
and ``flash_bwd.dkv_launches`` the two backward kernels'. A program being
exported records the forward as the custom op
``paddle_tpu_torch::flash_fwd`` (``custom_ops``).
"""
import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_bhsd",
           "flash_attention_with_lse", "flash_fwd", "flash_bwd",
           "FlashAttentionFunction", "FlashAttentionWithLseFunction",
           "NEG_INF"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# llama_tiny, nn's 256 / 8, llama_350m, nn's 768 / 8, Llama-2-7B/70B
HEAD_DIMS = (16, 32, 64, 96, 128)
MAX_BH = 65535


def _scores(q, k, sm_scale, causal):
    """f32 scores ``[..., S_q, S_k]``, masked to NEG_INF above the
    top-left-aligned diagonal when causal."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return s


def _ref_with_lse(q, k, v, sm_scale, causal):
    """Plain version of the forward on ``[..., S, D]``: (o in q's dtype,
    lse in f32). The composition of ``flash_attention.py:394-404`` with
    the Pallas kernels' top-left causal mask."""
    s = _scores(q, k, sm_scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("...qk,...kd->...qd", p, v.float())
    return o.to(q.dtype), lse


def _ref_bwd(q, k, v, o, lse, do, sm_scale, causal, dlse=None):
    """Plain version of the backward, written out as the kernels compute
    it (FlashAttention-2): ``delta = rowsum(do * o) - dlse``, ``p =
    exp(s - lse)``, ``ds = p * (do v^T - delta)``; dq = ds k * scale,
    dk = ds^T q * scale, dv = p^T do, each in its input's dtype."""
    dof = do.float()
    delta = (dof * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    p = torch.exp(_scores(q, k, sm_scale, causal) - lse.float()[..., None])
    dp = torch.einsum("...qd,...kd->...qk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("...qk,...kd->...qd", ds, k.float()) * sm_scale
    dk = torch.einsum("...qk,...qd->...kd", ds, q.float()) * sm_scale
    dv = torch.einsum("...qk,...qd->...kd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, o=None, lse=None, do=None, dlse=None):
    """The kernels' contract, checked before any pointer leaves Python."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q, k and v must be [batch * heads, seq, head_dim]")
    bh, sq, hd = q.shape
    if k.shape[0] != bh or k.shape[2] != hd or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS} (the other "
                         f"head dims: ROADMAP Queue 1 item 16)")
    if bh > MAX_BH or sq == 0 or k.shape[1] == 0:
        raise ValueError(f"batch * heads must be in 1..{MAX_BH} and the "
                         f"sequences non-empty, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("o", o), ("do", do)):
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype):
            raise ValueError(f"{name} must match q's shape and dtype")
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and (t.shape != (bh, sq)
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be [batch * heads, S_q] float32")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
                    ("do", do), ("dlse", dlse)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _fn(name, n_ptr):
    return _build.function(
        "flash_attention", name, [ctypes.c_void_p] * n_ptr
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])


def _dims(q, k, sm_scale, causal):
    bh, sq, hd = q.shape
    return (bh, sq, k.shape[1], hd, int(bool(causal)), _DTYPES[q.dtype],
            float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {err}")


def flash_fwd(q, k, v, sm_scale, causal):
    """K4a on ``[batch * heads, S, head_dim]``: (o in q's dtype, lse
    ``[batch * heads, S_q]`` f32). CUDA tensors run the kernel (f32 or
    bf16, head_dim 16/64/128, any lengths); CPU tensors run
    ``_ref_with_lse``."""
    if not q.is_cuda:
        return _ref_with_lse(q, k, v, sm_scale, causal)
    _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    err = _fn("flash_fwd_launch", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_dims(q, k, sm_scale, causal))
    _raise_on(err, "forward")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd(q, k, v, o, lse, do, sm_scale, causal, dlse=None):
    """K4b on ``[batch * heads, S, head_dim]``: (dq, dk, dv) in the
    inputs' dtypes from the saved o and lse and the output cotangent do
    (and the lse cotangent dlse, if any). CUDA tensors run the dq kernel
    (which also computes delta) and then the dk + dv kernel; no atomics,
    so the gradients are bitwise repeatable. CPU tensors run
    ``_ref_bwd``."""
    if not q.is_cuda:
        return _ref_bwd(q, k, v, o, lse, do, sm_scale, causal, dlse)
    _check(q, k, v, o, lse, do, dlse)
    dims = _dims(q, k, sm_scale, causal)
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    err = _fn("flash_bwd_dq_launch", 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        None if dlse is None else dlse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *dims)
    _raise_on(err, "dq")
    flash_bwd.dq_launches += 1
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _fn("flash_bwd_dkv_launch", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *dims)
    _raise_on(err, "dk + dv")
    flash_bwd.dkv_launches += 1
    return dq, dk, dv


flash_fwd.launches = 0
flash_bwd.dq_launches = 0
flash_bwd.dkv_launches = 0


def _flat(t):
    """``[B, H, S, D]`` -> contiguous ``[B * H, S, D]``."""
    return t.contiguous().reshape(-1, t.shape[-2], t.shape[-1])


def _forward(ctx, q, k, v, sm_scale, causal):
    """K4a on ``[B, H, S, D]``; saves what K4b needs. Returns (o ``[B, H,
    S, D]``, lse ``[B, H, S]``)."""
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    o, lse = flash_fwd(qf, kf, vf, sm_scale, causal)
    ctx.save_for_backward(qf, kf, vf, o, lse)
    ctx.sm_scale, ctx.causal, ctx.shapes = sm_scale, causal, \
        (q.shape, k.shape)
    return o.reshape(q.shape), lse.reshape(q.shape[:-1])


def _backward(ctx, do, dlse):
    """K4b for the saved forward; ``dlse`` may be None."""
    qf, kf, vf, o, lse = ctx.saved_tensors
    qs, ks = ctx.shapes
    if dlse is not None:
        dlse = dlse.float().contiguous().reshape(lse.shape)
    dq, dk, dv = flash_bwd(qf, kf, vf, o, lse, _flat(do), ctx.sm_scale,
                           ctx.causal, dlse=dlse)
    return dq.reshape(qs), dk.reshape(ks), dv.reshape(ks), None, None


class FlashAttentionFunction(torch.autograd.Function):
    """``_flash`` of ``flash_attention.py:349-389`` on ``[B, H, S, D]``:
    o from K4a, (dq, dk, dv) from K4b."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        return _forward(ctx, q, k, v, sm_scale, causal)[0]

    @staticmethod
    def backward(ctx, do):
        return _backward(ctx, do, None)


class FlashAttentionWithLseFunction(torch.autograd.Function):
    """``flash_attention_with_lse`` of ``flash_attention.py:407-455`` on
    ``[B, H, S, D]``: (o, lse ``[B, H, S]``), lse differentiable; its
    cotangent folds into the backward's delta."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        return _forward(ctx, q, k, v, sm_scale, causal)

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx, do, dlse)


def flash_attention_with_lse(q, k, v, sm_scale, causal):
    """``[B, H, S, D]`` attention returning (o, lse ``[B, H, S]``), both
    differentiable."""
    return FlashAttentionWithLseFunction.apply(q, k, v, sm_scale, causal)


def flash_attention_bhsd(q, k, v, causal=False, sm_scale=None):
    """The kernels on the ``[batch, heads, seq, head_dim]`` layout. A
    program being exported records K4a as the custom op
    ``paddle_tpu_torch::flash_fwd`` (``custom_ops``; no backward)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.compiler.is_exporting():
        o, _ = torch.ops.paddle_tpu_torch.flash_fwd(
            _flat(q), _flat(k), _flat(v), float(sm_scale), bool(causal))
        return o.reshape(q.shape)
    return FlashAttentionFunction.apply(q, k, v, sm_scale, causal)


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """q, k, v in the paddle layout ``[batch, seq, num_heads, head_dim]``
    (k and v with as many heads as q); returns o in the same layout."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return flash_attention_bhsd(qt, kt, vt, causal, sm_scale).transpose(1, 2)

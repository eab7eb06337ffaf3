"""Rotary position embedding (neox / llama half rotation).

Port of ``paddle_tpu/ops/pallas/rope.py``: ``precompute_freqs``, the
plain composition (the gather-at-position-ids rotation) and the kernel
route. On the card a call without ``position_ids`` on 4-D tensors takes
the rope kernel (K6, ``ops.kernels.rope``): ``apply_rotary`` one launch
per tensor, ``apply_rotary_qk`` one launch for q and k together, forward
and backward. Every other call takes the composition: CPU tensors, and
calls with ``position_ids`` (serving passes them, so serving never takes
the kernel).

The reference routes to its Pallas kernel only under ``PT_ROPE_PALLAS=1``
(``rope.py:24-36``): on a TPU, XLA fuses the composition into the
neighbouring matmuls, and the kernel waited for an on-chip A/B. Torch
eager fuses nothing, so on the card the composition is some ten
elementwise, cat and copy kernels per call, and the kernel is the
default. The results do not differ: K6 is the composition bit for bit,
forward and backward (f32 and bf16, f32 and bf16 tables).
"""
import torch

from .kernels.rope import apply_rotary_kernel, apply_rotary_qk_kernel

__all__ = ["precompute_freqs", "apply_rotary", "apply_rotary_qk",
           "apply_rotary_kernel", "apply_rotary_qk_kernel",
           "fused_rotary_position_embedding"]

# True sends every call to the composition, kernel route or not: a
# module-private switch for measuring the composition against K6 on the
# card (chip_smoke.py), not an option of the port
_COMPOSITION_ONLY = False


def precompute_freqs(head_dim, max_seq_len, theta=10000.0,
                     dtype=torch.float32, device=None):
    """cos/sin tables ``[max_seq_len, head_dim // 2]``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                       # [S, D/2]
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def _kernel_route(position_ids, *xs):
    """K6 takes the call: no ``position_ids``, 4-D tensors on the card."""
    return (position_ids is None and not _COMPOSITION_ONLY
            and all(x.dim() == 4 and x.is_cuda for x in xs))


def _composition(x, cos, sin, position_ids):
    """``_apply_rotary_jnp``: positions past the table are CLAMPED to its
    last row. The JAX composition gathers with ``jnp.take``, whose
    out-of-range fill is NaN; an index past the table raises on the CPU
    and trips a device assert on CUDA in torch. Only rows nobody reads sit
    there (the server's idle sentinel ``t0 = max_cache_len`` and parked
    decode rows), and their page writes are null-redirected with a zeroed
    payload either way, so the two packages differ in those garbage rows
    only: NaN there, finite here."""
    seq = x.shape[1]
    if position_ids is not None:
        idx = position_ids.long().clamp(0, cos.shape[0] - 1)
        c = cos[idx][:, :, None, :]                   # [B, S, 1, D/2]
        s = sin[idx][:, :, None, :]
    else:
        c = cos[None, :seq, None, :]
        s = sin[None, :seq, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_rotary(x, cos, sin, position_ids=None):
    """x ``[B, S, H, D]``; cos/sin ``[S_max, D/2]``; ``position_ids``
    ``[B, S]`` absolute positions (None: rows 0..S-1). On the card without
    ``position_ids`` K6 (``apply_rotary_kernel``, differentiable, its
    backward K6 too); otherwise the composition (``_composition``)."""
    if _kernel_route(position_ids, x):
        return apply_rotary_kernel(x, cos, sin)
    return _composition(x, cos, sin, position_ids)


def apply_rotary_qk(q, k, cos, sin, position_ids=None):
    """Rope of q ``[B, S, Hq, D]`` and k ``[B, S, Hk, D]`` at the same
    positions: ``(apply_rotary(q), apply_rotary(k))``, as the reference
    model's single rope dispatch over ``(q, k)``. On the card without
    ``position_ids`` one K6 launch for both (``apply_rotary_qk_kernel``),
    forward and backward; otherwise the composition on each."""
    if _kernel_route(position_ids, q, k):
        return apply_rotary_qk_kernel(q, k, cos, sin)
    return (_composition(q, cos, sin, position_ids),
            _composition(k, cos, sin, position_ids))


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """paddle.incubate.nn.functional.fused_rotary_position_embedding
    parity (``rope.py:56-62``; the incubate entry point,
    ``incubate/nn/functional.py:89-103``, is this function): ``(rope(q),
    rope(k), v)``, q and k through ``apply_rotary_qk`` (one K6 launch on
    the card), a lone q or k through ``apply_rotary``; a missing k or v
    stays None. The neox half rotation is the only style, as in the
    reference."""
    if q is not None and k is not None:
        q, k = apply_rotary_qk(q, k, cos, sin, position_ids)
        return q, k, v

    def rot(t):
        return None if t is None else apply_rotary(t, cos, sin, position_ids)

    return rot(q), rot(k), v

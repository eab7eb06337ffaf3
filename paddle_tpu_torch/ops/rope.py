"""Rotary position embedding (neox / llama half rotation).

Port of ``paddle_tpu/ops/pallas/rope.py``: ``precompute_freqs``, the
plain composition (the gather-at-position-ids rotation) and the
reference's opt-in kernel route. As in the reference, ``PT_ROPE_PALLAS=1``
(read at call time) sends a call without ``position_ids`` on a 4-D x to
the rope kernel (K6, ``ops.kernels.rope``) when x lies on the card, the
counterpart of ``on_tpu()``; every other call takes the composition.
Serving passes ``position_ids``, so it never takes the kernel.
"""
import os

import torch

from .kernels.rope import apply_rotary_kernel

__all__ = ["precompute_freqs", "apply_rotary", "apply_rotary_kernel",
           "fused_rotary_position_embedding"]


def precompute_freqs(head_dim, max_seq_len, theta=10000.0,
                     dtype=torch.float32, device=None):
    """cos/sin tables ``[max_seq_len, head_dim // 2]``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                       # [S, D/2]
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rotary(x, cos, sin, position_ids=None):
    """x ``[B, S, H, D]``; cos/sin ``[S_max, D/2]``; ``position_ids``
    ``[B, S]`` absolute positions (None: rows 0..S-1).

    With ``PT_ROPE_PALLAS=1``, no ``position_ids``, a 4-D x and x on the
    card, this runs K6 (``apply_rotary_kernel``, differentiable, its
    backward K6 too), as ``rope.py:24-36`` routes to the Pallas kernel on
    a TPU. Otherwise the composition below.

    Positions past the table are CLAMPED to its last row. The JAX
    composition gathers with ``jnp.take``, whose out-of-range fill is
    NaN; an index past the table raises on the CPU and trips a device
    assert on CUDA in torch. Only rows nobody reads sit there (the
    server's idle sentinel ``t0 = max_cache_len`` and parked decode
    rows), and their page writes are null-redirected with a zeroed
    payload either way, so the two packages differ in those garbage rows
    only: NaN there, finite here."""
    if (position_ids is None and os.environ.get("PT_ROPE_PALLAS") == "1"
            and x.dim() == 4 and x.is_cuda):
        return apply_rotary_kernel(x, cos, sin)
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


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """paddle.incubate.nn.functional.fused_rotary_position_embedding
    parity (``rope.py:56-62``; the incubate entry point,
    ``incubate/nn/functional.py:89-103``, is this function): ``(rope(q),
    rope(k), v)`` through ``apply_rotary``, so K6 when opted in; a
    missing k or v stays None. The neox half rotation is the only style,
    as in the reference."""
    def rot(t):
        return None if t is None else apply_rotary(t, cos, sin, position_ids)

    return rot(q), rot(k), v

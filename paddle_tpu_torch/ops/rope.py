"""Rotary position embedding (neox / llama half rotation).

Port of ``paddle_tpu/ops/pallas/rope.py``'s plain composition
(``precompute_freqs`` and the gather-at-position-ids rotation). The rope
kernel of the JAX package is opt-in there and not on the serving path,
so this module is plain torch.
"""
import torch

__all__ = ["precompute_freqs", "apply_rotary"]


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

    Positions past the table are CLAMPED to its last row. The JAX
    composition gathers with ``jnp.take``, whose out-of-range fill is
    NaN; an index past the table raises on the CPU and trips a device
    assert on CUDA in torch. Only rows nobody reads sit there (the
    server's idle sentinel ``t0 = max_cache_len`` and parked decode
    rows), and their page writes are null-redirected with a zeroed
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

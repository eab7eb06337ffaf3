"""Fused linear + softmax cross-entropy, chunked: the ``[T, V]`` logits
are never whole.

Port of ``paddle_tpu/ops/fused_ce.py``. The tokens go in chunks of
``chunk_size`` (the last one shorter when it does not divide): a chunk's
logits (``h @ weight``, in hidden's type, then f32) live only inside its
forward, and its backward recomputes them (the reference's
``jax.checkpoint`` of each scan step). Peak memory for the loss drops
from the ``T x V`` f32 logits to one chunk's. The matmuls are
``torch.matmul``, as the reference computes them outside any kernel.
"""
import torch

__all__ = ["fused_linear_cross_entropy"]


def _logits(h, weight, dtype):
    return (h @ weight).to(dtype)


class _ChunkLoss(torch.autograd.Function):
    """``sum(logsumexp(logits) - logits[label])`` of one chunk; saves the
    chunk's inputs only and recomputes its logits in the backward."""

    @staticmethod
    def forward(ctx, h, weight, labels, dtype):
        logits = _logits(h, weight, dtype)
        tgt = logits.gather(-1, labels[:, None])[:, 0]
        ctx.save_for_backward(h, weight, labels)
        ctx.dtype = dtype
        return (torch.logsumexp(logits, dim=-1) - tgt).sum()

    @staticmethod
    def backward(ctx, g):
        h, weight, labels = ctx.saved_tensors
        prod = h @ weight
        d = torch.softmax(prod.to(ctx.dtype), dim=-1)
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, labels] -= 1.0
        d = (d * g).to(prod.dtype)
        dh = d @ weight.t() if ctx.needs_input_grad[0] else None
        dw = h.t() @ d if ctx.needs_input_grad[1] else None
        return dh, dw, None, None


def fused_linear_cross_entropy(hidden, weight, labels, chunk_size=1024,
                               reduction="mean", logits_dtype=None):
    """``cross_entropy(hidden @ weight, labels)`` without the whole
    logits. ``hidden`` ``[T, H]`` or ``[B, S, H]`` (flattened),
    ``weight`` ``[H, V]``, ``labels`` int ``[T]`` or ``[B, S]``;
    ``reduction`` ``"mean"`` or ``"sum"``; the softmax statistics in
    ``logits_dtype`` (f32 by default). Differentiable in hidden and
    weight."""
    if reduction not in ("mean", "sum"):
        raise ValueError("chunked CE supports reduction='mean'|'sum'")
    h2 = hidden.reshape(-1, hidden.shape[-1])
    lb = torch.as_tensor(labels, device=h2.device).reshape(-1).long()
    dtype = logits_dtype or torch.float32
    T = h2.shape[0]
    c = min(chunk_size, T)
    total = torch.zeros((), dtype=torch.float32, device=h2.device)
    for start in range(0, T, c):
        total = total + _ChunkLoss.apply(h2[start:start + c], weight,
                                         lb[start:start + c], dtype)
    return total / T if reduction == "mean" else total

"""MoE gate zoo: naive / gshard / switch.

Port of ``paddle_tpu/parallel/moe/gate.py`` (reference:
python/paddle/incubate/distributed/models/moe/gate/ naive_gate.py,
gshard_gate.py, switch_gate.py). The gates return dense dispatch tensors
(combine weights and the dispatch mask): the sort-free einsum
formulation, whose dispatch and gather are large matrix products.

The dispatch functions take ``[..., T, E]`` logits, so the grouped form
``[G, g, D]`` (GShard token groups) is one batched call where the
reference ``vmap``s over the groups: capacity is per group, positions
run in token order within a group, and the aux loss is the mean over the
groups. The routing is discrete: softmax in f32, ``argmax`` takes the
first maximum, a token's position in its expert is a cumsum in token
order, and ``combine > 0`` is the dispatch mask (a second gate that
underflows to 0 is dropped, as in the reference).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tf

from ...core import random as rnd
from ...nn.layer import Layer
from ...nn.layers_basic import Linear

__all__ = ["NaiveGate", "GShardGate", "SwitchGate", "TopKGateOutput"]


class TopKGateOutput:
    def __init__(self, combine, dispatch_mask, aux_loss, indices=None):
        self.combine = combine          # [tokens, experts, capacity]
        self.dispatch_mask = dispatch_mask
        self.aux_loss = aux_loss
        self.indices = indices


def _top1(probs):
    """(the largest value, its first index) over the last axis."""
    i = torch.argmax(probs, dim=-1)
    return probs.gather(-1, i.unsqueeze(-1)).squeeze(-1), i


def _aux(probs, i1):
    """GShard's load-balance loss (eq. 4): E * sum_e f_e * p_e, one a
    group."""
    E = probs.shape[-1]
    me = probs.mean(dim=-2)
    ce = tf.one_hot(i1, E).to(probs.dtype).mean(dim=-2)
    return (me * ce).sum(dim=-1) * E


def _slots(pos, keep, capacity):
    """One-hot capacity slots ``[..., T, E, C]`` (f32) of the kept
    positions."""
    return tf.one_hot(pos.clamp(0, capacity - 1), capacity).float() \
        * keep.unsqueeze(-1)


def _top2_dense_dispatch(logits, capacity, second_policy="random",
                         noise_eps=0.0):
    """GShard top-2 dispatch to (combine, mask) dense tensors.

    logits: [..., T, E] raw gate scores. Returns combine [..., T, E, C]
    and the bool mask [..., T, E, C] plus the load-balance aux loss (one
    a leading index)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)

    g1, i1 = _top1(probs)
    mask1 = tf.one_hot(i1, E)
    g2, i2 = _top1(probs * (1.0 - mask1.to(probs.dtype)))
    aux = _aux(probs, i1)

    mask2 = tf.one_hot(i2, E)
    pos1 = torch.cumsum(mask1, dim=-2) * mask1 - 1     # position in expert
    pos2 = (torch.cumsum(mask2, dim=-2)
            + mask1.sum(dim=-2, keepdim=True)) * mask2 - 1
    keep1 = (pos1 < capacity) & (mask1 > 0)
    keep2 = (pos2 < capacity) & (mask2 > 0)

    denom = g1 + g2 + 1e-9
    w1 = (g1 / denom)[..., None, None]
    w2 = (g2 / denom)[..., None, None]
    combine = w1 * _slots(pos1, keep1, capacity) \
        + w2 * _slots(pos2, keep2, capacity)        # [..., T, E, C]
    return combine, combine > 0, aux


def _top1_dense_dispatch(logits, capacity, jitter_eps=0.0, training=True):
    """Switch-style top-1 dispatch. The jitter is one uniform draw of
    ``[T, E]`` from the global key, shared by every group (the
    reference's ``vmap`` draws it once)."""
    E = logits.shape[-1]
    if jitter_eps > 0.0 and training:
        from ...ops.kernels.threefry_fill import uniform
        noise = uniform(rnd.next_key(), logits.shape[-2:], logits.device,
                        1.0 - jitter_eps, 1.0 + jitter_eps)
        logits = logits * noise
    probs = torch.softmax(logits.float(), dim=-1)
    g1, i1 = _top1(probs)
    aux = _aux(probs, i1)
    mask1 = tf.one_hot(i1, E)
    pos1 = torch.cumsum(mask1, dim=-2) * mask1 - 1
    keep1 = (pos1 < capacity) & (mask1 > 0)
    combine = g1[..., None, None] * _slots(pos1, keep1, capacity)
    return combine, combine > 0, aux


class _GateBase(Layer):
    """The router ``gate.weight`` ``[d_model, E]``; ``draw=False`` leaves
    it undrawn for a model that draws every weight itself."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=1.25,
                 *, dtype=None, device=None, draw=True):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.gate = Linear(d_model, num_experts, bias_attr=False,
                           dtype=dtype, device=device, draw=draw)

    def capacity(self, num_tokens):
        return max(4, int(math.ceil(
            num_tokens * self.top_k * self.capacity_factor
            / self.num_experts)))


class NaiveGate(_GateBase):
    """Reference naive_gate.py: plain top-k softmax, no capacity drops.

    Accepts flat tokens [T, D] or grouped tokens [G, g, D] (GShard token
    groups: capacity is per group, the dispatch batched over groups)."""

    def forward(self, x):
        grouped = x.dim() == 3
        cap = self.capacity(x.shape[1] if grouped else x.shape[0])
        combine, mask, aux = _top2_dense_dispatch(x @ self.gate.weight, cap)
        return TopKGateOutput(combine, mask,
                              aux.mean() if grouped else aux)


class GShardGate(_GateBase):
    """Reference gshard_gate.py: top-2 + capacity + aux load-balance loss."""

    forward = NaiveGate.forward


class SwitchGate(_GateBase):
    """Reference switch_gate.py: top-1 + jitter."""

    def __init__(self, d_model, num_experts, capacity_factor=1.25,
                 jitter=0.01, *, dtype=None, device=None):
        super().__init__(d_model, num_experts, top_k=1,
                         capacity_factor=capacity_factor, dtype=dtype,
                         device=device)
        self.jitter = jitter

    def forward(self, x):
        grouped = x.dim() == 3
        cap = self.capacity(x.shape[1] if grouped else x.shape[0])
        combine, mask, aux = _top1_dense_dispatch(
            x @ self.gate.weight, cap, self.jitter, self.training)
        return TopKGateOutput(combine, mask,
                              aux.mean() if grouped else aux)

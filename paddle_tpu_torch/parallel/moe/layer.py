"""MoE layer: stacked experts and the dense-dispatch ``MoELayer``.

Port of ``paddle_tpu/parallel/moe/layer.py`` (reference:
python/paddle/incubate/distributed/models/moe/moe_layer.py:261 MoELayer:
gate -> MoEScatter/MoEGather over global_scatter/global_gather). The gate
gives dense combine weights; the dispatch (``gtec,gtd->gecd``), the
stacked experts' products and the gather (``gtec,gecd->gtd``) are large
matrix products (cuBLAS on the card), as they are plain XLA products
outside any Pallas kernel in the reference. The dispatch mask is in the
activations' dtype and the combine weights are cast to it before the
gather, as in the reference. Capacity-bucket shapes are static.

One card only: the expert-parallel exchange (``all_to_all`` over the
mesh's expert axis) is ROADMAP Queue 1 item 13's four-card part, so a
``moe_group`` or ``mp_group`` raises.
"""
from __future__ import annotations

import warnings

import torch

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import Layer, LayerList
from ...nn.layers_basic import _Placed
from .gate import GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer", "ExpertMLP", "ExpertSwiGLU"]


class ExpertMLP(_Placed):
    """Stacked experts: weights carry a leading expert dim so one batched
    product computes all experts."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu",
                 *, dtype=None, device=None):
        super().__init__(dtype, device)
        self.num_experts = num_experts
        init = I.XavierNormal()
        self.w1 = self.create_parameter((num_experts, d_model, d_hidden),
                                        default_initializer=init, draw=False)
        self.b1 = self.create_parameter((num_experts, 1, d_hidden),
                                        is_bias=True, draw=False)
        self.w2 = self.create_parameter((num_experts, d_hidden, d_model),
                                        default_initializer=init, draw=False)
        self.b2 = self.create_parameter((num_experts, 1, d_model),
                                        is_bias=True, draw=False)
        self.activation = activation
        self.reset_parameters()

    def reset_parameters(self):
        for p in (self.w1, self.b1, self.w2, self.b2):
            self.init_parameter(p)

    def forward(self, x):
        """x: [E, C, D] capacity buckets -> [E, C, D]."""
        h = torch.bmm(x, self.w1) + self.b1
        h = F.gelu(h, approximate=True) if self.activation == "gelu" \
            else F.relu(h)
        return torch.bmm(h, self.w2) + self.b2


class ExpertSwiGLU(_Placed):
    """Stacked SwiGLU experts (Mixtral/DeepSeek-MoE FFN shape): each expert
    is gate/up/down with silu, weights stacked on a leading expert dim so
    one batched product serves all experts; ``draw=False`` leaves them
    undrawn for a model that draws every weight itself."""

    def __init__(self, num_experts, d_model, d_hidden, *, dtype=None,
                 device=None, draw=True):
        super().__init__(dtype, device)
        self.num_experts = num_experts
        init = I.XavierNormal()
        self.w_gate = self.create_parameter(
            (num_experts, d_model, d_hidden), default_initializer=init,
            draw=False)
        self.w_up = self.create_parameter(
            (num_experts, d_model, d_hidden), default_initializer=init,
            draw=False)
        self.w_down = self.create_parameter(
            (num_experts, d_hidden, d_model), default_initializer=init,
            draw=False)
        if draw:
            self.reset_parameters()

    def reset_parameters(self):
        for p in (self.w_gate, self.w_up, self.w_down):
            self.init_parameter(p)

    def forward(self, x):
        """x: [E, C, D] capacity buckets -> [E, C, D]."""
        g = torch.bmm(x, self.w_gate)
        u = torch.bmm(x, self.w_up)
        return torch.bmm(F.silu(g) * u, self.w_down)


class MoELayer(Layer):
    """Reference moe_layer.py:261 MoELayer(d_model, experts, gate, ...).

    gate: "naive" | "gshard" | "switch" | Layer instance.

    ``group_size``: GShard-style token grouping. Dense dispatch products
    cost O(T * E * C * D) with C ∝ T/E — quadratic in tokens per dispatch
    group. Grouping tokens into G groups of ``group_size`` (per sequence
    is the natural choice) keeps each dispatch small while the expert
    product still sees one large [E, G*C, D] batch.
    """

    GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}

    def __init__(self, d_model, experts=None, gate="gshard", num_experts=None,
                 d_hidden=None, top_k=2, capacity_factor=1.25,
                 moe_group=None, mp_group=None, recompute_interval=0,
                 group_size=None, *, dtype=None, device=None):
        super().__init__()
        if moe_group is not None or mp_group is not None:
            raise NotImplementedError(
                "MoELayer(moe_group=/mp_group=): the expert-parallel "
                "all_to_all is not ported (ROADMAP, Queue 1 item 13: "
                "multi-card training)")
        self.d_model = d_model
        self.group_size = group_size
        if experts is not None and isinstance(experts, (list, LayerList)):
            # reference-style per-expert module list
            num_experts = len(experts)
            self.experts = experts if isinstance(experts, LayerList) else \
                LayerList(experts)
        elif experts is not None and isinstance(experts, torch.nn.Module):
            # pre-built stacked expert bank (ExpertMLP / ExpertSwiGLU)
            num_experts = num_experts or experts.num_experts
            self.experts = experts
        else:
            self.experts = ExpertMLP(num_experts, d_model,
                                     d_hidden or 4 * d_model, dtype=dtype,
                                     device=device)
        self.num_experts = num_experts
        if isinstance(gate, str):
            gate_cls = self.GATES[gate]
            kw = dict(capacity_factor=capacity_factor, dtype=dtype,
                      device=device)
            if gate != "switch":
                kw["top_k"] = top_k
            self.gate = gate_cls(d_model, num_experts, **kw)
        else:
            self.gate = gate
        self.aux_loss = None

    def _apply_experts(self, buckets):
        """buckets [E, C, D] -> [E, C, D]. Stacked banks run as one
        batched product; a reference-style per-expert LayerList runs each
        expert on its bucket slice (E is small and static)."""
        if isinstance(self.experts, LayerList):
            return torch.stack([exp(buckets[e])
                                for e, exp in enumerate(self.experts)])
        return self.experts(buckets)

    def forward(self, x):
        """x: [B, S, D] -> [B, S, D]; stores aux_loss for the trainer."""
        shape = x.shape
        d = shape[-1]
        tokens = x.numel() // d
        xf = x.reshape(tokens, d)
        g = self.group_size
        if g and tokens % g == 0 and tokens > g:
            return self._forward_grouped(xf, tokens // g, g, d).reshape(shape)
        if g and tokens > g and tokens % g != 0:
            # tokens <= g is the normal sub-group batch (whole-batch
            # dispatch is exactly right); only a true partial-group split
            # changes the capacity/drop profile and deserves a warning
            warnings.warn(
                f"MoELayer group_size={g} does not divide {tokens} tokens; "
                "falling back to whole-batch dispatch (different capacity "
                "and drop profile)")
        gate_out = self.gate(xf)
        self.aux_loss = gate_out.aux_loss
        combine = gate_out.combine            # [T, E, C]
        disp = (combine > 0).to(xf.dtype)
        buckets = torch.einsum("tec,td->ecd", disp, xf)    # [E, C, D]
        out_buckets = self._apply_experts(buckets)
        out = torch.einsum("tec,ecd->td", combine.to(out_buckets.dtype),
                           out_buckets)
        return out.reshape(shape)

    def _forward_grouped(self, xf, n_groups, group, d):
        """GShard grouped dispatch: xf [T, D] viewed as [G, g, D]; capacity
        and dispatch are per group, the expert products run once on the
        concatenated [E, G*C, D] buckets."""
        xg = xf.reshape(n_groups, group, d)
        gate_out = self.gate(xg)
        self.aux_loss = gate_out.aux_loss
        combine = gate_out.combine            # [G, g, E, C]
        gg, _t, e, c = combine.shape
        disp = (combine > 0).to(xg.dtype)
        buckets = torch.einsum("gtec,gtd->gecd", disp, xg)
        flat = buckets.transpose(0, 1).reshape(e, gg * c, d)
        ob = self._apply_experts(flat)        # [E, G*C, D]
        ob = ob.reshape(e, gg, c, -1).transpose(0, 1)
        out = torch.einsum("gtec,gecd->gtd", combine.to(ob.dtype), ob)
        return out.reshape(n_groups * group, d)

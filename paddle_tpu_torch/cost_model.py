"""paddle.cost_model parity (reference python/paddle/cost_model/ +
auto_parallel/cost/): static-program cost estimation.

Port of ``paddle_tpu/cost_model.py``. Costs come from

- per-op ANALYTIC rules over a static ``Program``'s recorded shapes
  (the port's ``static.graph``: the same blocks, ops and variables as the
  reference's): matmul/conv/einsum count tensor-core FLOPs (2*M*N*K);
  embedding/gather count memory bytes (random access is bandwidth-, not
  FLOP-, bound); everything else counts elementwise bytes;
- ``xla_cost_analysis(fn, *args)``, the whole-function count. Its name
  is the reference's API (the reference asks XLA's compiler); the port
  counts the function's operations as it runs with
  ``torch.utils.flop_counter.FlopCounterMode`` and its bytes as each
  input read once and each output written once.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CostModel", "xla_cost_analysis"]

_MATMUL_OPS = ("matmul", "mm", "bmm", "linear", "einsum", "conv", "addmm",
               "fused_gemm", "quant_matmul", "fc")
_LOOKUP_OPS = ("embedding", "gather", "take", "index_select",
               "scatter", "one_hot")


def _shape_of(block, ref):
    from .static.graph import VarRef
    if isinstance(ref, VarRef):
        return _var_shape(block.vars.get(ref.name))
    return tuple(getattr(ref, "shape", ()))


def _var_shape(var):
    if var is None:
        return ()
    for attr in ("shape", "_shape"):
        s = getattr(var, attr, None)
        if s is not None:
            return tuple(s)
    v = getattr(var, "_value", None)
    return tuple(getattr(v, "shape", ())) if v is not None else ()


def _op_cost(block, op):
    """(flops, bytes, kind) for one recorded op."""
    in_shapes = [_shape_of(block, i) for i in op.inputs]
    out_shapes = [_var_shape(block.vars.get(o)) for o in op.outputs]
    out_elems = sum(int(np.prod(s)) if s else 1 for s in out_shapes)
    in_elems = sum(int(np.prod(s)) if s else 1 for s in in_shapes)
    t = op.op_type.lower()
    if any(k in t for k in _MATMUL_OPS):
        # out [.., M, N]; contraction dim K from the first input's last
        k = in_shapes[0][-1] if in_shapes and in_shapes[0] else 1
        # conv: K = receptive field x C_in; approximate from weight elems
        if "conv" in t and len(in_shapes) > 1 and in_shapes[1]:
            w = in_shapes[1]
            k = int(np.prod(w)) // max(int(w[0]), 1)
        return 2.0 * out_elems * max(int(k), 1), \
            4.0 * (in_elems + out_elems), "matmul"
    if any(k in t for k in _LOOKUP_OPS):
        return 0.0, 4.0 * (in_elems + out_elems), "lookup"
    return float(out_elems), 4.0 * (in_elems + out_elems), "elementwise"


class CostModel:
    def profile_measure(self, main_program, startup_program=None,
                        device="gpu", fetch_cost_list=("time",)):
        """Per-op-type cost for a static Program from the analytic rules
        (reference: profile-runs the program; here shape arithmetic gives
        FLOPs directly). Returns {op_type: flops + bytes} so both
        compute- and bandwidth-bound ops rank sensibly."""
        block = main_program.global_block
        costs = {}
        for op in block.ops:
            flops, bts, _kind = _op_cost(block, op)
            costs[op.op_type] = costs.get(op.op_type, 0) + flops + bts
        return costs

    def measure_program(self, main_program):
        """Roofline inputs for the layout tuner: totals by kind.

        Returns {"matmul_flops", "lookup_bytes", "elementwise_bytes",
        "total_flops", "matmul_frac"} (reference auto_parallel/cost
        CompOpCost tables collapsed to the two resources that matter on
        the card: tensor-core FLOPs and memory bytes)."""
        block = main_program.global_block
        agg = {"matmul_flops": 0.0, "lookup_bytes": 0.0,
               "elementwise_bytes": 0.0, "total_flops": 0.0}
        for op in block.ops:
            flops, bts, kind = _op_cost(block, op)
            agg["total_flops"] += flops
            if kind == "matmul":
                agg["matmul_flops"] += flops
            elif kind == "lookup":
                agg["lookup_bytes"] += bts
            else:
                agg["elementwise_bytes"] += bts
        agg["matmul_frac"] = (agg["matmul_flops"]
                              / max(agg["total_flops"], 1.0))
        return agg

    def static_cost_data(self):
        return []


def xla_cost_analysis(fn, *args, **kwargs):
    """Whole-function cost of ``fn(*args, **kwargs)``: ``"flops"`` (the
    floating-point operations torch's flop counter finds, a matmul of
    ``[M, K] @ [K, N]`` counting ``2*M*N*K``) and ``"bytes accessed"``
    (every tensor argument read once, every tensor output written once),
    the reference's keys. ``fn`` runs once on its arguments (torch
    tensors, paddle Tensors, or meta tensors for shapes alone)."""
    import torch
    from torch.utils import _pytree
    from torch.utils.flop_counter import FlopCounterMode

    from .nn.layer import _unwrap_tree
    args, kwargs = _unwrap_tree(args), _unwrap_tree(kwargs)
    counter = FlopCounterMode(display=False)
    with counter:
        out = _unwrap_tree(fn(*args, **kwargs))

    def nbytes(tree):
        return float(sum(t.numel() * t.element_size()
                         for t in _pytree.tree_leaves(tree)
                         if isinstance(t, torch.Tensor)))

    return {"flops": float(counter.get_total_flops()),
            "bytes accessed": nbytes((args, kwargs)) + nbytes(out)}

"""Declarative op table: the single source of truth for oracle coverage.

Copied from ``paddle_tpu/ops/optable.py`` (numpy and scipy only; the port
imports nothing of the JAX package). One change: ``np.trapz`` is taken
as ``np.trapezoid`` where numpy has it (numpy 2 renamed it).

Reference analogue: paddle/phi/api/yaml/ops.yaml + the OpTest suites
(python/paddle/fluid/tests/unittests/test_*_op.py) — one declarative spec
per op drives both the API surface check and the numpy-oracle tests
(tests/test_optable_oracle.py parameterizes directly over TABLE).

Each row: (name, variant, inputs, attrs, ref, tol, call). `inputs` is an
ordered dict of numpy generators (fresh seeded rng per case); `ref` maps
the generated numpy inputs to the expected output (array or tuple);
`call` optionally overrides the default `op(*tensors, **attrs)` calling
convention (list-taking ops, method calls, inplace variants).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_trapz = getattr(np, "trapezoid", None) or np.trapz

__all__ = ["TABLE", "OpCase", "coverage_names"]


@dataclasses.dataclass
class OpCase:
    name: str                  # public op name in the paddle_tpu namespace
    variant: str               # case id suffix
    inputs: dict               # arg name -> numpy generator ()->array
    attrs: dict                # static kwargs
    ref: callable              # (*np arrays) -> np array | tuple
    atol: float = 1e-5
    rtol: float = 1e-5
    call: callable = None      # (op, tensors: list, attrs) -> output

    @property
    def case_id(self):
        return f"{self.name}:{self.variant}" if self.variant else self.name


TABLE: list[OpCase] = []


def _add(name, ref, inputs, attrs=None, variant="", atol=1e-5, rtol=1e-5,
         call=None):
    TABLE.append(OpCase(name, variant, inputs, dict(attrs or {}), ref,
                        atol, rtol, call))


def _rng(seed):
    return np.random.RandomState(seed)


def F(seed=0, shape=(4, 6), lo=-2.0, hi=2.0, dtype=np.float32):
    return lambda: _rng(seed).uniform(lo, hi, shape).astype(dtype)


def FP(seed=0, shape=(4, 6)):   # positive
    return F(seed, shape, 0.3, 3.0)


def FU(seed=0, shape=(4, 6)):   # in (-0.9, 0.9)
    return F(seed, shape, -0.9, 0.9)


def I(seed=0, shape=(4, 6), lo=0, hi=8, dtype=np.int64):
    return lambda: _rng(seed).randint(lo, hi, shape).astype(dtype)


def B(seed=0, shape=(4, 6)):
    return lambda: _rng(seed).rand(*shape) > 0.5


# =============================================================== unary

try:
    import scipy.special as _sps
except ImportError:          # pragma: no cover
    _sps = None

_UNARY = [
    ("abs", np.abs, F), ("exp", np.exp, FU), ("expm1", np.expm1, FU),
    ("log", np.log, FP), ("log2", np.log2, FP), ("log10", np.log10, FP),
    ("log1p", np.log1p, FP), ("sqrt", np.sqrt, FP),
    ("rsqrt", lambda v: 1 / np.sqrt(v), FP), ("square", np.square, F),
    ("sin", np.sin, F), ("cos", np.cos, F), ("tan", np.tan, FU),
    ("asin", np.arcsin, FU), ("acos", np.arccos, FU),
    ("atan", np.arctan, F), ("sinh", np.sinh, F), ("cosh", np.cosh, F),
    ("tanh", np.tanh, F), ("asinh", np.arcsinh, F),
    ("acosh", np.arccosh, lambda s=0, **k: F(s, (4, 6), 1.1, 3.0)),
    ("atanh", np.arctanh, FU), ("ceil", np.ceil, F),
    ("floor", np.floor, F), ("round", np.round, F),
    ("trunc", np.trunc, F), ("sign", np.sign, F),
    ("neg", np.negative, F), ("reciprocal", np.reciprocal, FP),
    ("sigmoid", lambda v: 1 / (1 + np.exp(-v)), F),
    ("frac", lambda v: v - np.trunc(v), F),
    ("relu", lambda v: np.maximum(v, 0), F),
    ("relu6", lambda v: np.clip(v, 0, 6), F),
    ("silu", lambda v: v / (1 + np.exp(-v)), F),
    ("softsign", lambda v: v / (1 + np.abs(v)), F),
    ("softplus", lambda v: np.log1p(np.exp(-np.abs(v))) + np.maximum(v, 0),
     F),
    ("hardsigmoid", lambda v: np.clip(v / 6 + 0.5, 0, 1), F),
    ("hardswish", lambda v: v * np.clip(v + 3, 0, 6) / 6, F),
    ("hardtanh", lambda v: np.clip(v, -1, 1), F),
    ("leaky_relu", lambda v: np.where(v > 0, v, 0.01 * v), F),
    ("elu", lambda v: np.where(v > 0, v, np.expm1(v)), F),
    ("celu", lambda v: np.where(v > 0, v, np.expm1(v)), F),
    ("selu", lambda v: 1.0507009873554805 * np.where(
        v > 0, v, 1.6732632423543772 * np.expm1(v)), F),
    ("mish", lambda v: v * np.tanh(np.log1p(np.exp(-np.abs(v)))
                                   + np.maximum(v, 0)), F),
    ("gelu", (lambda v: 0.5 * v * (1 + _sps.erf(v / np.sqrt(2.0))))
     if _sps else None, F),
    ("logsigmoid", lambda v: -(np.log1p(np.exp(-np.abs(v)))
                               + np.maximum(-v, 0)), F),
    ("tanhshrink", lambda v: v - np.tanh(v), F),
    ("softshrink", lambda v: np.where(v > 0.5, v - 0.5,
                                      np.where(v < -0.5, v + 0.5, 0)), F),
    ("hardshrink", lambda v: np.where(np.abs(v) > 0.5, v, 0), F),
]
if _sps is not None:
    _UNARY += [
        ("erf", _sps.erf, F), ("erfinv", _sps.erfinv, FU),
        ("lgamma", _sps.gammaln, FP), ("digamma", _sps.digamma, FP),
        ("logit", _sps.logit, lambda s=0, **k: F(s, (4, 6), 0.1, 0.9)),
        ("log_softmax",
         lambda v: v - _sps.logsumexp(v, axis=-1, keepdims=True), F),
    ]

for i, (nm, ref, gen) in enumerate(_UNARY):
    _add(nm, ref, {"x": gen(i)}, atol=3e-5, rtol=3e-5)

# second shape variant for a representative subset (3-d input)
for i, nm in enumerate(["exp", "tanh", "relu", "sigmoid", "abs", "sqrt",
                        "log", "sin", "gelu", "softplus"]):
    ref = dict((n, r) for n, r, _ in _UNARY)[nm]
    gen = FP(100 + i, (2, 3, 4)) if nm in ("sqrt", "log") \
        else F(100 + i, (2, 3, 4))
    _add(nm, ref, {"x": gen}, variant="3d", atol=3e-5, rtol=3e-5)

# =============================================================== binary

_BIN = [
    ("add", np.add), ("subtract", np.subtract),
    ("multiply", np.multiply), ("maximum", np.maximum),
    ("minimum", np.minimum), ("fmax", np.fmax), ("fmin", np.fmin),
    ("atan2", np.arctan2), ("hypot", np.hypot),
    ("logaddexp", np.logaddexp), ("heaviside", np.heaviside),
    ("copysign", np.copysign),
]
for i, (nm, ref) in enumerate(_BIN):
    _add(nm, ref, {"x": F(2 * i), "y": F(2 * i + 1)})
    _add(nm, ref, {"x": F(2 * i, (4, 6)), "y": F(2 * i + 1, (6,))},
         variant="bcast")

_add("divide", np.divide, {"x": F(40), "y": FP(41)})
_add("pow", np.power, {"x": FP(42), "y": F(43)}, atol=1e-4, rtol=1e-4)
_add("remainder", np.remainder, {"x": F(44), "y": FP(45)})
_add("mod", np.mod, {"x": F(46), "y": FP(47)})
_add("floor_divide", np.floor_divide, {"x": F(48), "y": FP(49)})
_add("gcd", np.gcd, {"x": I(50, hi=30), "y": I(51, lo=1, hi=30)})
_add("lcm", np.lcm, {"x": I(52, lo=1, hi=12), "y": I(53, lo=1, hi=12)})
_add("lerp", lambda x, y, w: x + w * (y - x),
     {"x": F(54), "y": F(55), "weight": F(56, (1,), 0.0, 1.0)})

# comparisons & logical
for i, (nm, ref) in enumerate([
        ("equal", np.equal), ("not_equal", np.not_equal),
        ("greater_than", np.greater), ("greater_equal", np.greater_equal),
        ("less_than", np.less), ("less_equal", np.less_equal)]):
    _add(nm, ref, {"x": I(60 + i, hi=4), "y": I(70 + i, hi=4)})
for i, (nm, ref) in enumerate([
        ("logical_and", np.logical_and), ("logical_or", np.logical_or),
        ("logical_xor", np.logical_xor)]):
    _add(nm, ref, {"x": B(80 + i), "y": B(90 + i)})
_add("logical_not", np.logical_not, {"x": B(99)})
for i, (nm, ref) in enumerate([
        ("bitwise_and", np.bitwise_and), ("bitwise_or", np.bitwise_or),
        ("bitwise_xor", np.bitwise_xor)]):
    _add(nm, ref, {"x": I(100 + i, dtype=np.int32),
                   "y": I(110 + i, dtype=np.int32)})
_add("bitwise_not", np.invert, {"x": I(119, dtype=np.int32)})
_add("bitwise_left_shift", np.left_shift,
     {"x": I(120, dtype=np.int32), "y": I(121, hi=4, dtype=np.int32)})
_add("bitwise_right_shift", np.right_shift,
     {"x": I(122, dtype=np.int32), "y": I(123, hi=4, dtype=np.int32)})
_add("isnan", np.isnan, {"x": F(124)})
_add("isinf", np.isinf, {"x": F(125)})
_add("isfinite", np.isfinite, {"x": F(126)})
_add("isclose", np.isclose, {"x": F(127), "y": F(127)})
_add("nan_to_num", np.nan_to_num,
     {"x": lambda: np.array([[1.0, np.nan, np.inf, -np.inf]],
                            np.float32)})

# =============================================================== reduce

_RED = [("sum", np.sum), ("mean", np.mean), ("max", np.max),
        ("min", np.min), ("amax", np.amax), ("amin", np.amin),
        ("prod", np.prod), ("nansum", np.nansum), ("nanmean", np.nanmean)]
for i, (nm, ref) in enumerate(_RED):
    gen = FP(130 + i, (4, 6))
    _add(nm, lambda v, r=ref: r(v), {"x": gen}, atol=1e-4, rtol=1e-4)
    _add(nm, lambda v, r=ref: r(v, axis=0), {"x": gen},
         attrs={"axis": 0}, variant="ax0", atol=1e-4, rtol=1e-4)
    _add(nm, lambda v, r=ref: r(v, axis=-1), {"x": gen},
         attrs={"axis": -1}, variant="axm1", atol=1e-4, rtol=1e-4)
    _add(nm, lambda v, r=ref: r(v, axis=1, keepdims=True), {"x": gen},
         attrs={"axis": 1, "keepdim": True}, variant="keep",
         atol=1e-4, rtol=1e-4)
_add("var", lambda v: np.var(v, ddof=1), {"x": F(140)}, atol=1e-4)
_add("var", lambda v: np.var(v, axis=1, ddof=0), {"x": F(141)},
     attrs={"axis": 1, "unbiased": False}, variant="ax1", atol=1e-4)
_add("std", lambda v: np.std(v, ddof=1), {"x": F(142)}, atol=1e-4)
_add("logsumexp",
     (lambda v: _sps.logsumexp(v, axis=-1)) if _sps else None,
     {"x": F(143)}, attrs={"axis": -1}, atol=1e-4)
_add("count_nonzero", np.count_nonzero, {"x": I(144, hi=3)})
_add("all", lambda v: np.all(v, axis=1), {"x": B(145)},
     attrs={"axis": 1})
_add("any", lambda v: np.any(v, axis=1), {"x": B(146)},
     attrs={"axis": 1})
_add("median", lambda v: np.median(v, axis=-1), {"x": F(147, (4, 5))},
     attrs={"axis": -1}, atol=1e-5)

# ========================================================== cumulative

_add("cumsum", lambda v: np.cumsum(v, 1), {"x": F(150)},
     attrs={"axis": 1})
_add("cumsum", lambda v: np.cumsum(v, 0), {"x": F(151)},
     attrs={"axis": 0}, variant="ax0")
_add("cumprod", lambda v: np.cumprod(v, 1), {"x": FU(152)},
     attrs={"dim": 1})
_add("cummax", lambda v: np.maximum.accumulate(v, 1), {"x": F(153)},
     attrs={"axis": 1},
     call=lambda op, ts, at: op(*ts, **at)[0])
_add("cummin", lambda v: np.minimum.accumulate(v, 1), {"x": F(154)},
     attrs={"axis": 1},
     call=lambda op, ts, at: op(*ts, **at)[0])
_add("logcumsumexp",
     (lambda v: np.log(np.cumsum(np.exp(v), 1))) if True else None,
     {"x": FU(155)}, attrs={"axis": 1}, atol=1e-4)

# =================================================== sorting/searching

_add("sort", lambda v: np.sort(v, 1), {"x": F(160)}, attrs={"axis": 1})
_add("sort", lambda v: -np.sort(-v, 1), {"x": F(161)},
     attrs={"axis": 1, "descending": True}, variant="desc")
_add("argsort", lambda v: np.argsort(v, 1, kind="stable"), {"x": F(162)},
     attrs={"axis": 1})
_add("argmax", lambda v: np.argmax(v, 1), {"x": F(163)},
     attrs={"axis": 1})
_add("argmin", lambda v: np.argmin(v, 0), {"x": F(164)},
     attrs={"axis": 0})
_add("topk", lambda v: -np.sort(-v, -1)[..., :3], {"x": F(165)},
     attrs={"k": 3}, call=lambda op, ts, at: op(*ts, **at)[0])
_add("kthvalue", lambda v: np.sort(v, -1)[..., 1], {"x": F(166)},
     attrs={"k": 2}, call=lambda op, ts, at: op(*ts, **at)[0])
_add("mode", lambda v: np.array([1.0, 1.0], np.float32),
     {"x": lambda: np.tile(np.array([[3.0, 1.0, 1.0]], np.float32),
                           (2, 1))},
     call=lambda op, ts, at: op(*ts, **at)[0])
_add("searchsorted",
     lambda s, v: np.searchsorted(s[0], v[0])[None],
     {"sorted_sequence": lambda: np.sort(
         _rng(168).uniform(-2, 2, (1, 8)).astype(np.float32), -1),
      "values": lambda: _rng(169).uniform(-2, 2, (1, 5)).astype(
          np.float32)})
_add("bucketize",
     lambda v, s: np.searchsorted(s, v),
     {"x": F(170), "sorted_sequence": lambda: np.array(
         [-1.0, 0.0, 1.0], np.float32)})
_add("nonzero", lambda v: np.stack(np.nonzero(v), 1),
     {"x": lambda: np.array([[0.0, 1.0], [2.0, 0.0]], np.float32)})
_add("where", np.where, {"condition": B(171), "x": F(172), "y": F(173)})
_add("masked_select", lambda v, m: v[m],
     {"x": lambda: np.arange(12, dtype=np.float32).reshape(3, 4),
      "mask": lambda: (np.arange(12).reshape(3, 4) % 2 == 0)})
_add("masked_fill", lambda v, m: np.where(m, 7.0, v).astype(np.float32),
     {"x": F(174), "mask": B(175)}, attrs={"value": 7.0})
_add("unique", lambda v: np.unique(v),
     {"x": lambda: np.array([3.0, 1.0, 1.0, 2.0], np.float32)},
     call=lambda op, ts, at: op(*ts, **at))
_add("unique_consecutive", lambda v: np.array([1.0, 2.0, 1.0],
                                              np.float32),
     {"x": lambda: np.array([1.0, 1.0, 2.0, 2.0, 1.0], np.float32)},
     call=lambda op, ts, at: op(*ts, **at)[0] if isinstance(
         op(*ts, **at), (tuple, list)) else op(*ts, **at))

# ======================================================== manipulation

A34 = lambda s=180: F(s, (3, 4))
_add("reshape", lambda v: v.reshape(6, 2), {"x": A34()},
     attrs={"shape": [6, 2]})
_add("reshape", lambda v: v.reshape(-1), {"x": A34(181)},
     attrs={"shape": [-1]}, variant="flat")
_add("transpose", lambda v: v.T, {"x": A34(182)}, attrs={"perm": [1, 0]})
_add("t", lambda v: v.T, {"x": A34(183)})
_add("flip", lambda v: np.flip(v, 0), {"x": A34(184)}, attrs={"axis": 0})
_add("roll", lambda v: np.roll(v, 2, 1), {"x": A34(185)},
     attrs={"shifts": 2, "axis": 1})
_add("tile", lambda v: np.tile(v, (2, 1)), {"x": A34(186)},
     attrs={"repeat_times": [2, 1]})
_add("squeeze", lambda v: v.squeeze(1),
     {"x": lambda: _rng(187).randn(3, 1, 4).astype(np.float32)},
     attrs={"axis": 1})
_add("unsqueeze", lambda v: v[:, None], {"x": A34(188)},
     attrs={"axis": 1})
_add("expand", lambda v: np.broadcast_to(v, (3, 4)),
     {"x": lambda: _rng(189).randn(1, 4).astype(np.float32)},
     attrs={"shape": [3, 4]})
_add("broadcast_to", lambda v: np.broadcast_to(v, (3, 4)),
     {"x": lambda: _rng(190).randn(1, 4).astype(np.float32)},
     attrs={"shape": [3, 4]})
_add("moveaxis", lambda v: np.moveaxis(v, 0, 1), {"x": A34(191)},
     attrs={"source": 0, "destination": 1})
_add("swapaxes", lambda v: np.swapaxes(v, 0, 1), {"x": A34(192)},
     attrs={"axis1": 0, "axis2": 1})
_add("rot90", lambda v: np.rot90(v), {"x": A34(193)})
_add("flatten", lambda v: v.reshape(-1),
     {"x": lambda: _rng(194).randn(2, 3, 4).astype(np.float32)},
     attrs={"start_axis": 0, "stop_axis": -1})
_add("tril", np.tril, {"x": A34(195)})
_add("triu", np.triu, {"x": A34(196)})
_add("diag", np.diag, {"x": lambda: _rng(197).randn(4).astype(
    np.float32)})
_add("diagonal", lambda v: np.diagonal(v, 0, 0, 1),
     {"x": lambda: _rng(198).randn(4, 4).astype(np.float32)})
_add("diagflat", np.diagflat, {"x": lambda: _rng(199).randn(3).astype(
    np.float32)})
_add("diag_embed", lambda v: np.stack([np.diag(r) for r in v]),
     {"x": A34(200)})
_add("repeat_interleave", lambda v: np.repeat(v, 2, 1), {"x": A34(201)},
     attrs={"repeats": 2, "axis": 1})
_add("index_select", lambda v, i: v[i],
     {"x": A34(202), "index": lambda: np.array([2, 0], np.int64)},
     attrs={"axis": 0})
_add("gather", lambda v, i: v[i],
     {"x": A34(203), "index": lambda: np.array([1, 2], np.int64)})
_add("take_along_axis", lambda v, i: np.take_along_axis(v, i, 1),
     {"arr": A34(204),
      "indices": lambda: np.argsort(_rng(204).uniform(
          -2, 2, (3, 4)).astype(np.float32), 1)},
     attrs={"axis": 1})
def _index_add_ref(v, i, s):
    out = v.copy()
    out[i] += s
    return out


_add("index_add", _index_add_ref,
     {"x": lambda: np.zeros((3, 4), np.float32),
      "index": lambda: np.array([0, 2], np.int64),
      "value": lambda: np.ones((2, 4), np.float32)},
     attrs={"axis": 0},
     call=lambda op, ts, at: op(ts[0], ts[1], at["axis"], ts[2]))
_add("pad", lambda v: np.pad(v, ((1, 1), (2, 2))), {"x": A34(205)},
     attrs={"pad": [1, 1, 2, 2]})
_add("one_hot", lambda i: np.eye(5, dtype=np.float32)[i],
     {"x": lambda: np.array([0, 3, 4], np.int64)},
     attrs={"num_classes": 5})
_add("crop", lambda v: v[1:3, 1:3],
     {"x": lambda: _rng(206).randn(4, 4).astype(np.float32)},
     attrs={"shape": [2, 2], "offsets": [1, 1]})
_add("slice", lambda v: v[1:3],
     {"x": lambda: _rng(207).randn(4, 4).astype(np.float32)},
     attrs={"axes": [0], "starts": [1], "ends": [3]})
_add("strided_slice", lambda v: v[0:4:2],
     {"x": lambda: _rng(208).randn(4, 4).astype(np.float32)},
     attrs={"axes": [0], "starts": [0], "ends": [4], "strides": [2]})

# =============================================================== linalg

SQ = lambda s: (lambda: (_rng(s).randn(3, 3) + 3 * np.eye(3)).astype(
    np.float32))
SPD = lambda s: (lambda: (lambda a: (a @ a.T + 3 * np.eye(3)).astype(
    np.float32))(_rng(s).randn(3, 3)))

_add("matmul", lambda a, b: a @ b,
     {"x": F(210, (3, 4)), "y": F(211, (4, 5))}, atol=1e-4)
_add("matmul", lambda a, b: a @ b,
     {"x": F(212, (2, 3, 4)), "y": F(213, (2, 4, 5))}, variant="batch",
     atol=1e-4)
_add("mm", lambda a, b: a @ b, {"x": F(214, (3, 4)), "y": F(215, (4, 5))},
     atol=1e-4)
_add("bmm", lambda a, b: a @ b,
     {"x": F(216, (2, 3, 4)), "y": F(217, (2, 4, 5))}, atol=1e-4)
_add("mv", lambda a, v: a @ v, {"x": F(218, (3, 4)), "vec": F(219, (4,))},
     atol=1e-4)
_add("dot", np.dot, {"x": F(220, (5,)), "y": F(221, (5,))}, atol=1e-4)
_add("inner", np.inner, {"x": F(222, (3, 4)), "y": F(223, (5, 4))},
     atol=1e-4)
_add("outer", np.outer, {"x": F(224, (3,)), "y": F(225, (4,))}, atol=1e-4)
_add("kron", np.kron, {"x": F(226, (2, 2)), "y": F(227, (2, 3))},
     atol=1e-4)
_add("cross", lambda a, b: np.cross(a, b),
     {"x": F(228, (4, 3)), "y": F(229, (4, 3))}, atol=1e-4)
_add("trace", np.trace, {"x": SQ(230)}, atol=1e-4)
_add("inverse", np.linalg.inv, {"x": SQ(231)}, atol=1e-3, rtol=1e-3)
_add("det", np.linalg.det, {"x": SQ(232)}, atol=1e-3, rtol=1e-3)
_add("slogdet", lambda a: np.stack(np.linalg.slogdet(a)), {"x": SPD(233)},
     atol=1e-3, rtol=1e-3)
_add("matrix_power", lambda a: np.linalg.matrix_power(a, 3),
     {"x": SQ(234)}, attrs={"n": 3}, atol=1e-3, rtol=1e-3)
_add("cholesky", np.linalg.cholesky, {"x": SPD(235)}, atol=1e-3)
_add("solve", lambda a, b: np.linalg.solve(a, b),
     {"x": SQ(236), "y": F(237, (3, 2))}, atol=1e-3, rtol=1e-3)
_add("triangular_solve",
     lambda a, b: np.linalg.solve(np.triu(a), b),
     {"x": lambda: (np.triu(_rng(238).randn(3, 3)) + 3 * np.eye(3)
                    ).astype(np.float32),
      "y": F(239, (3, 2))}, attrs={"upper": True}, atol=1e-3, rtol=1e-3)
_add("cholesky_solve",
     lambda b, l: np.linalg.solve(l @ l.T, b),
     {"x": F(240, (3, 2)),
      "y": lambda: np.linalg.cholesky(SPD(241)()).astype(np.float32)},
     attrs={"upper": False}, atol=1e-3, rtol=1e-3)
_add("pinv", np.linalg.pinv, {"x": F(242, (4, 3))}, atol=1e-3, rtol=1e-3)
_add("matrix_rank", lambda a: np.linalg.matrix_rank(a), {"x": SPD(243)})
_add("norm", lambda v: np.linalg.norm(v), {"x": F(244)}, atol=1e-4)
_add("norm", lambda v: np.linalg.norm(v, axis=1), {"x": F(245)},
     attrs={"axis": 1}, variant="ax1", atol=1e-4)
_add("norm", lambda v: np.abs(v).sum(axis=1), {"x": F(246)},
     attrs={"p": 1, "axis": 1}, variant="l1", atol=1e-4)
_add("vector_norm", lambda v: np.linalg.norm(v.reshape(-1)),
     {"x": F(247)}, atol=1e-4)
_add("matrix_norm", lambda v: np.linalg.norm(v, "fro"), {"x": F(248)},
     attrs={"p": "fro"}, atol=1e-4)
_add("multi_dot", lambda a, b, c: a @ b @ c,
     {"x": F(249, (2, 3)), "y": F(250, (3, 4)), "z": F(251, (4, 2))},
     call=lambda op, ts, at: op(ts), atol=1e-4)
_add("histogram", lambda v: np.histogram(v, bins=4, range=(-2, 2))[0],
     {"x": F(252, (20,))}, attrs={"bins": 4, "min": -2, "max": 2})
_add("bincount", lambda v: np.bincount(v),
     {"x": lambda: np.array([0, 1, 1, 3], np.int64)})
_add("cov", lambda v: np.cov(v), {"x": F(253, (3, 8))}, atol=1e-4,
     rtol=1e-4)
_add("corrcoef", lambda v: np.corrcoef(v), {"x": F(254, (3, 8))},
     atol=1e-4, rtol=1e-4)
_add("dist", lambda a, b: np.linalg.norm((a - b).reshape(-1)),
     {"x": F(255), "y": F(256)}, atol=1e-4)

# eigen/factorization families: compare invariants (reconstruction /
# eigenvalues) rather than sign-ambiguous factors
_add("eigh", lambda a: np.linalg.eigvalsh(a), {"x": SPD(257)},
     call=lambda op, ts, at: op(*ts, **at)[0], atol=1e-3, rtol=1e-3)
_add("eigvalsh", lambda a: np.linalg.eigvalsh(a), {"x": SPD(258)},
     atol=1e-3, rtol=1e-3)
_add("qr", lambda a: np.abs(np.linalg.qr(a)[1]), {"x": F(259, (4, 3))},
     call=lambda op, ts, at: abs(op(*ts, **at)[1]), atol=1e-3, rtol=1e-3)
_add("svd", lambda a: np.linalg.svd(a, compute_uv=False),
     {"x": F(260, (4, 3))},
     call=lambda op, ts, at: op(*ts, **at)[1], atol=1e-3, rtol=1e-3)

# ============================================================= creation

_add("zeros", lambda: np.zeros((3, 4), np.float32), {},
     attrs={"shape": [3, 4]})
_add("ones", lambda: np.ones((3, 4), np.float32), {},
     attrs={"shape": [3, 4]})
_add("full", lambda: np.full((2, 3), 2.5, np.float32), {},
     attrs={"shape": [2, 3], "fill_value": 2.5})
_add("eye", lambda: np.eye(4, dtype=np.float32), {},
     attrs={"num_rows": 4})
_add("arange", lambda: np.arange(0, 10, 2, dtype=np.float32), {},
     attrs={"start": 0, "end": 10, "step": 2})
_add("linspace", lambda: np.linspace(0, 1, 5, dtype=np.float32), {},
     attrs={"start": 0, "stop": 1, "num": 5})
_add("zeros_like", np.zeros_like, {"x": F(261)})
_add("ones_like", np.ones_like, {"x": F(262)})
_add("full_like", lambda v: np.full_like(v, 3.0), {"x": F(263)},
     attrs={"fill_value": 3.0})
_add("tril_indices", lambda: np.stack(np.tril_indices(4)), {},
     attrs={"row": 4, "col": 4})
_add("triu_indices", lambda: np.stack(np.triu_indices(4)), {},
     attrs={"row": 4, "col": 4})
_add("clip", lambda v: np.clip(v, -0.5, 0.5), {"x": F(264)},
     attrs={"min": -0.5, "max": 0.5})
_add("cast", lambda v: v.astype(np.int32), {"x": FP(265)},
     attrs={"dtype": "int32"})
_add("numel", lambda v: np.int64(v.size), {"x": F(266)})
_add("scale", lambda v: v * 2.0 + 1.0, {"x": F(267)},
     attrs={"scale": 2.0, "bias": 1.0})

# ====================================================== combining ops

_add("concat", lambda a, b: np.concatenate([a, b], 0),
     {"x": A34(270), "y": A34(271)},
     call=lambda op, ts, at: op(list(ts), axis=0))
_add("concat", lambda a, b: np.concatenate([a, b], 1),
     {"x": A34(272), "y": A34(273)}, variant="ax1",
     call=lambda op, ts, at: op(list(ts), axis=1))
_add("stack", lambda a, b: np.stack([a, b], 0),
     {"x": A34(274), "y": A34(275)},
     call=lambda op, ts, at: op(list(ts), axis=0))
_add("stack", lambda a, b: np.stack([a, b], 1),
     {"x": A34(276), "y": A34(277)}, variant="ax1",
     call=lambda op, ts, at: op(list(ts), axis=1))
_add("hstack", lambda a, b: np.hstack([a, b]),
     {"x": A34(278), "y": A34(279)},
     call=lambda op, ts, at: op(list(ts)))
_add("vstack", lambda a, b: np.vstack([a, b]),
     {"x": A34(280), "y": A34(281)},
     call=lambda op, ts, at: op(list(ts)))
_add("split", lambda v: tuple(np.split(v, 2, 1)),
     {"x": F(282, (3, 4))},
     call=lambda op, ts, at: tuple(op(ts[0], 2, axis=1)))
_add("chunk", lambda v: tuple(np.array_split(v, 2, 0)),
     {"x": F(283, (4, 3))},
     call=lambda op, ts, at: tuple(op(ts[0], 2, axis=0)))
_add("unbind", lambda v: tuple(v[i] for i in range(3)),
     {"x": F(284, (3, 4))},
     call=lambda op, ts, at: tuple(op(ts[0], axis=0)))
_add("unstack", lambda v: tuple(v[:, i] for i in range(3)),
     {"x": F(285, (4, 3))},
     call=lambda op, ts, at: tuple(op(ts[0], axis=1)))
_add("meshgrid", lambda a, b: tuple(np.meshgrid(a, b, indexing="ij")),
     {"x": F(286, (3,)), "y": F(287, (4,))},
     call=lambda op, ts, at: tuple(op(*ts)))
_add("einsum", lambda a, b: np.einsum("ij,jk->ik", a, b),
     {"x": F(288, (3, 4)), "y": F(289, (4, 5))},
     call=lambda op, ts, at: op("ij,jk->ik", *ts), atol=1e-4)
_add("einsum", lambda a: np.einsum("ii->", a), {"x": SQ(290)},
     call=lambda op, ts, at: op("ii->", ts[0]), variant="trace",
     atol=1e-4)

# ======================================================= int arithmetic

for i, (nm, ref) in enumerate([("add", np.add), ("subtract", np.subtract),
                               ("multiply", np.multiply),
                               ("maximum", np.maximum),
                               ("minimum", np.minimum)]):
    _add(nm, ref, {"x": I(300 + i, dtype=np.int32),
                   "y": I(310 + i, dtype=np.int32)}, variant="int32")

# ================================================ nn.functional oracle

_add("softmax", (lambda v: np.exp(v - _sps.logsumexp(
    v, axis=-1, keepdims=True))) if _sps else None, {"x": F(320)},
     attrs={"axis": -1}, atol=1e-5)
_add("softmax", (lambda v: np.exp(v - _sps.logsumexp(
    v, axis=0, keepdims=True))) if _sps else None, {"x": F(321)},
     attrs={"axis": 0}, variant="ax0", atol=1e-5)
_add("normalize",
     lambda v: v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True),
                              1e-12),
     {"x": F(322)}, attrs={"axis": 1}, atol=1e-5)
_add("cosine_similarity",
     lambda a, b: (a * b).sum(1) / np.maximum(
         np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-8),
     {"x1": F(323), "x2": F(324)}, attrs={"axis": 1}, atol=1e-5)
_add("linear", lambda x, w, b: x @ w + b,
     {"x": F(325, (3, 4)), "weight": F(326, (4, 5)),
      "bias": F(327, (5,))}, atol=1e-4)
_add("mse_loss", lambda a, b: np.mean((a - b) ** 2),
     {"input": F(328), "label": F(329)}, atol=1e-5)
_add("l1_loss", lambda a, b: np.mean(np.abs(a - b)),
     {"input": F(330), "label": F(331)}, atol=1e-5)
_add("kl_div",
     (lambda lp, t: np.mean(t * (np.log(t) - lp))) if True else None,
     {"input": lambda: np.log(_rng(332).dirichlet(
         np.ones(6), 4).astype(np.float32)),
      "label": lambda: _rng(333).dirichlet(
          np.ones(6), 4).astype(np.float32)},
     attrs={"reduction": "mean"}, atol=1e-5)
_add("binary_cross_entropy",
     lambda p, t: np.mean(-(t * np.log(p) + (1 - t) * np.log(1 - p))),
     {"input": lambda: _rng(334).uniform(0.1, 0.9, (4, 6)).astype(
         np.float32),
      "label": lambda: (_rng(335).rand(4, 6) > 0.5).astype(np.float32)},
     atol=1e-5)
_add("one_hot", lambda i: np.eye(6, dtype=np.float32)[i],
     {"x": lambda: np.array([[1, 5], [0, 2]], np.int64)},
     attrs={"num_classes": 6}, variant="2d")
_add("embedding", lambda i, w: w[i],
     {"x": lambda: np.array([[0, 2], [1, 1]], np.int64),
      "weight": F(336, (4, 5))})
_add("label_smooth",
     lambda v: v * 0.9 + 0.1 / 6,
     {"label": lambda: np.eye(6, dtype=np.float32)[
         np.array([0, 2, 4, 1])]},
     attrs={"epsilon": 0.1}, atol=1e-5)

# ====================================================== complex/other

_add("real", np.real, {"x": lambda: (_rng(340).randn(3, 4)
                                     + 1j * _rng(341).randn(3, 4)).astype(
                                         np.complex64)})
_add("imag", np.imag, {"x": lambda: (_rng(342).randn(3, 4)
                                     + 1j * _rng(343).randn(3, 4)).astype(
                                         np.complex64)})
_add("conj", np.conj, {"x": lambda: (_rng(344).randn(3, 4)
                                     + 1j * _rng(345).randn(3, 4)).astype(
                                         np.complex64)})
_add("angle", np.angle, {"x": lambda: (_rng(346).randn(3, 4)
                                       + 1j * _rng(347).randn(3, 4)
                                       ).astype(np.complex64)},
     atol=1e-5)
_add("complex", lambda r, i: r + 1j * i, {"real": F(348), "imag": F(349)})
_add("as_complex", lambda v: v[..., 0] + 1j * v[..., 1],
     {"x": F(350, (3, 4, 2))})
_add("as_real", lambda v: np.stack([v.real, v.imag], -1),
     {"x": lambda: (_rng(351).randn(3, 4) + 1j * _rng(352).randn(3, 4)
                    ).astype(np.complex64)})
_add("clone", lambda v: v, {"x": F(353)})
_add("assign", lambda v: v, {"x": F(354)})
_add("equal_all", lambda a, b: np.array(np.array_equal(a, b)),
     {"x": I(355, hi=3), "y": I(355, hi=3)})
_add("allclose", lambda a, b: np.array(np.allclose(a, b)),
     {"x": F(356), "y": F(356)})
_add("expand_as", lambda v, o: np.broadcast_to(v, o.shape),
     {"x": lambda: _rng(357).randn(1, 4).astype(np.float32),
      "y": F(358, (3, 4))})
_add("gather_nd", lambda v, i: v[tuple(i.T)],
     {"x": F(359, (3, 4)),
      "index": lambda: np.array([[0, 1], [2, 3]], np.int64)})
_add("scatter_nd_add",
     lambda v, i, u: (lambda o: (np.add.at(o, tuple(i.T), u), o)[1])(
         v.copy()),
     {"x": lambda: np.zeros((4,), np.float32),
      "index": lambda: np.array([[1], [2], [1]], np.int64),
      "updates": lambda: np.array([1.0, 2.0, 3.0], np.float32)})
_add("put_along_axis",
     lambda v, i, u: np.put_along_axis(v.copy(), i, u, 1) or
     (lambda o: (np.put_along_axis(o, i, u, 1), o)[1])(v.copy()),
     {"arr": F(360, (3, 4)),
      "indices": lambda: np.zeros((3, 1), np.int64),
      "values": lambda: np.full((3, 1), 9.0, np.float32)},
     attrs={"axis": 1})

# =================================================== round-3 op-tail batch
# (reference python/paddle/tensor/{math,manipulation,linalg}.py tail)

_add("deg2rad", np.deg2rad, {"x": F(400)})
_add("rad2deg", np.rad2deg, {"x": F(401)})
_add("sgn", np.sign, {"x": F(402)})
_add("negative", np.negative, {"x": F(403)})
_add("positive", np.positive, {"x": F(404)})
_add("nextafter", np.nextafter, {"x": F(405), "y": F(406)})
_add("ldexp", lambda x, y: np.ldexp(x, y.astype(np.int32)),
     {"x": F(407), "y": I(408, lo=-3, hi=4, dtype=np.int32)})
_add("frexp", lambda x: np.frexp(x), {"x": F(409)})
_add("isposinf",
     lambda x: np.isposinf(x),
     {"x": lambda: np.array([1.0, np.inf, -np.inf, np.nan], np.float32)})
_add("isneginf",
     lambda x: np.isneginf(x),
     {"x": lambda: np.array([1.0, np.inf, -np.inf, np.nan], np.float32)})
_add("isin", lambda x, t: np.isin(x, t),
     {"x": I(410, hi=6), "test_x": lambda: np.array([1, 3], np.int64)})
_add("diff", lambda x: np.diff(x), {"x": F(411)})
_add("trapezoid", lambda y: _trapz(y), {"y": F(412, (5,))})
_add("quantile", lambda x: np.quantile(x, 0.5),
     {"x": F(413)}, attrs={"q": 0.5})
_add("nanquantile", lambda x: np.nanquantile(x, 0.5),
     {"x": F(414)}, attrs={"q": 0.5})
_add("nanmedian", lambda x: np.nanmedian(x),
     {"x": lambda: np.array([[1.0, np.nan, 3.0],
                             [4.0, 5.0, np.nan]], np.float32)})
_add("xlogy", lambda x, y: np.where(x == 0, 0.0, x * np.log(y)),
     {"x": F(415, shape=(4, 6), lo=0.0, hi=2.0), "y": FP(416)}, atol=1e-4)
if _sps is not None:
    _add("gammaln", _sps.gammaln, {"x": FP(417)}, atol=1e-4)
    _add("gammainc", _sps.gammainc, {"x": FP(418), "y": FP(419)}, atol=1e-4)
    _add("gammaincc", _sps.gammaincc, {"x": FP(420), "y": FP(421)},
         atol=1e-4)
    _add("i0", _sps.i0, {"x": F(422)}, atol=1e-4)
    _add("i0e", _sps.i0e, {"x": F(423)}, atol=1e-5)
    _add("i1", _sps.i1, {"x": F(424)}, atol=1e-4)
    _add("i1e", _sps.i1e, {"x": F(425)}, atol=1e-5)
    _add("multigammaln", lambda x: _sps.multigammaln(x, 2),
         {"x": F(426, lo=1.2, hi=4.0)}, attrs={"p": 2}, atol=1e-4)
_add("unflatten", lambda x: x.reshape(4, 2, 3), {"x": F(427, (4, 6))},
     attrs={"axis": 1, "shape": (2, 3)})
_add("fliplr", np.fliplr, {"x": F(428)})
_add("flipud", np.flipud, {"x": F(429)})
_add("take", lambda x, i: np.take(x.reshape(-1), i),
     {"x": F(430), "index": lambda: np.array([0, 5, 11], np.int64)})
_add("index_fill",
     lambda x, i: (lambda o: (o.__setitem__((slice(None), i), 7.0), o)[1])(
         x.copy()),
     {"x": F(431), "index": lambda: np.array([0, 2], np.int64)},
     attrs={"axis": 1, "value": 7.0})
_add("tensor_split", lambda x: tuple(np.array_split(x, 3, 0)),
     {"x": F(432, (6, 4))}, attrs={"num_or_indices": 3})
_add("hsplit", lambda x: tuple(np.hsplit(x, 2)), {"x": F(433, (4, 6))},
     attrs={"num_or_indices": 2})
_add("vsplit", lambda x: tuple(np.vsplit(x, 2)), {"x": F(434, (4, 6))},
     attrs={"num_or_indices": 2})
_add("column_stack", lambda a, b: np.column_stack([a, b]),
     {"x": F(435, (4,)), "y": F(436, (4,))},
     call=lambda op, ts, at: op([ts[0], ts[1]]))
_add("hstack", lambda a, b: np.hstack([a, b]),
     {"x": F(437, (4,)), "y": F(438, (4,))},
     call=lambda op, ts, at: op([ts[0], ts[1]]))
_add("vstack", lambda a, b: np.vstack([a, b]),
     {"x": F(439, (4,)), "y": F(440, (4,))},
     call=lambda op, ts, at: op([ts[0], ts[1]]))
_add("dstack", lambda a, b: np.dstack([a, b]),
     {"x": F(441, (4,)), "y": F(442, (4,))},
     call=lambda op, ts, at: op([ts[0], ts[1]]))
_add("block_diag", lambda a, b: np.block(
    [[a, np.zeros((a.shape[0], b.shape[1]))],
     [np.zeros((b.shape[0], a.shape[1])), b]]).astype(np.float32),
     {"x": F(443, (2, 2)), "y": F(444, (3, 3))},
     call=lambda op, ts, at: op(ts[0], ts[1]))
_add("addmm", lambda i, x, y: i + x @ y,
     {"input": F(445, (4, 4)), "x": F(446, (4, 5)), "y": F(447, (5, 4))},
     atol=1e-4)
_add("baddbmm", lambda i, x, y: i + np.matmul(x, y),
     {"input": F(448, (2, 3, 3)), "x": F(449, (2, 3, 4)),
      "y": F(450, (2, 4, 3))}, atol=1e-4)
_add("vander", lambda x: np.vander(x), {"x": F(451, (5,))}, atol=1e-4)
_add("cdist",
     lambda a, b: np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                          + 1e-30),
     {"x": F(452, (4, 3)), "y": F(453, (5, 3))}, atol=1e-4)
_add("pdist",
     lambda a: np.sqrt(((a[:, None, :] - a[None, :, :]) ** 2).sum(-1)
                       + 1e-30)[np.triu_indices(a.shape[0], 1)],
     {"x": F(454, (5, 3))}, atol=1e-4)
_add("renorm",
     lambda x: x * np.minimum(
         1.0, 1.0 / (np.abs(x ** 2).sum(1) ** 0.5 + 1e-12))[:, None],
     {"x": F(455, (4, 6))}, attrs={"p": 2.0, "axis": 0, "max_norm": 1.0},
     atol=1e-4)
_add("cholesky_inverse",
     lambda L: np.linalg.inv(L @ L.T),
     {"x": lambda: np.linalg.cholesky(
         (lambda a: a @ a.T + 3 * np.eye(3))(
             _rng(456).randn(3, 3)).astype(np.float32))}, atol=1e-2,
     rtol=1e-3)
_add("masked_scatter",
     lambda x, m, v: (lambda o: (o.__setitem__(
         m, v.reshape(-1)[:int(m.sum())]), o)[1])(x.copy()),
     {"x": F(457), "mask": B(458), "value": F(459, (24,))})
_add("cumulative_trapezoid",
     lambda y: np.array([_trapz(y[:i + 2]) for i in range(len(y) - 1)],
                        np.float32),
     {"y": F(460, (6,))}, atol=1e-4)

# filter any rows whose ref ended up None (missing scipy)
TABLE = [c for c in TABLE if c is not None and c.ref is not None]


def coverage_names():
    return sorted({c.name for c in TABLE})

"""The port's tensor core on the CPU against the JAX package.

Ports ``tests/test_tensor_autograd.py`` and ``tests/test_ops_oracle.py``
case by case: each case runs the same script on ``paddle_tpu`` and on
``paddle_tpu_torch`` with inputs made from a seed with numpy, and the
values, dtypes and gradients must agree (float32 within 1e-5 unless a
case says otherwise; gradients checked by finite differences as the
reference's OpTest does, too). Then the points where torch's idiom and
the reference's tape could part: canonical dtypes, ``stop_gradient``,
in-place rebinds and hooks, indexing out of range, gradients at kinks
and ties, AMP O1 casts and the NaN/Inf check.

``test_random_reproducible`` of ``test_tensor_autograd.py`` is ported
in ``test_torch_random_ops.py`` with the random ops; here the draws of
``randn`` and ``Tensor.uniform_`` are the reference's under one seed.
"""
import warnings

import numpy as np
import pytest
import scipy.special as sps
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.dtype import dtype_name

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, (pt.Tensor, jt.Tensor)):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _name(x):
    if isinstance(x, pt.Tensor):
        return dtype_name(x.dtype)
    return np.dtype(x.dtype).name


def both(script, atol=TOL, rtol=TOL):
    """``script(mod)`` on the JAX package and on the port; every output
    (a tensor, an array, a number, or a list / tuple of them) equal
    within tolerance, tensors' dtypes equal. Returns the port's."""
    want = script(jt)
    got = script(pt)
    _same(got, want, atol, rtol)
    return got


def _same(got, want, atol, rtol, path="out"):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, atol, rtol, f"{path}[{i}]")
        return
    if want is None:
        assert got is None, path
        return
    if isinstance(want, jt.Tensor):
        assert isinstance(got, pt.Tensor), path
        assert _name(got) == _name(want), (path, _name(got), _name(want))
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   atol=atol, rtol=rtol, err_msg=path)


def _rng(seed=0):
    return np.random.RandomState(seed)


# ------------------------------------------------- test_tensor_autograd.py


def test_to_tensor_roundtrip():
    def s(m):
        x = m.to_tensor([[1.0, 2.0], [3.0, 4.0]])
        assert x.shape == [2, 2] and x.stop_gradient
        return x
    both(s)


def test_basic_arith_matches_numpy():
    a = _rng(1).randn(3, 4).astype(np.float32)
    b = _rng(2).randn(3, 4).astype(np.float32)

    def s(m):
        ta, tb = m.to_tensor(a), m.to_tensor(b)
        return [ta + tb, ta * tb, ta - tb, ta / (tb + 10), ta @ tb.T]
    got = both(s)
    for g, w in zip(got, [a + b, a * b, a - b, a / (b + 10), a @ b.T]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_backward_simple():
    def s(m):
        x = m.to_tensor([2.0, 3.0], stop_gradient=False)
        (x * x).sum().backward()
        return x.grad
    np.testing.assert_allclose(both(s).numpy(), [4.0, 6.0])


def test_backward_chain_and_accumulation():
    def s(m):
        x = m.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 3.0
        (y * y).sum().backward()
        first = x.grad.numpy().copy()
        (x * 2.0).sum().backward()
        return [first, x.grad]
    got = both(s)
    np.testing.assert_allclose(got[1].numpy(), [20.0, 38.0])


def test_backward_through_shared_subexpr():
    def s(m):
        x = m.to_tensor(2.0, stop_gradient=False)
        y = x * x
        (y + y).backward()
        return x.grad
    np.testing.assert_allclose(both(s).numpy(), 8.0)


def test_matmul_grad_matches_numeric():
    a = _rng(3).randn(4, 5).astype(np.float32)
    b = _rng(4).randn(5, 3).astype(np.float32)

    def s(m):
        ta = m.to_tensor(a, stop_gradient=False)
        tb = m.to_tensor(b, stop_gradient=False)
        (ta @ tb).sum().backward()
        return [ta.grad, tb.grad]
    got = both(s)
    np.testing.assert_allclose(got[0].numpy(), np.ones((4, 3)) @ b.T,
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), a.T @ np.ones((4, 3)),
                               rtol=1e-5)


def test_no_grad_blocks_tape():
    def s(m):
        x = m.to_tensor([1.0], stop_gradient=False)
        with m.no_grad():
            y = x * 5.0
        assert y.stop_gradient and y.is_leaf
        return y
    both(s)


def test_stop_gradient_cuts_graph():
    def s(m):
        x = m.to_tensor([1.0, 2.0], stop_gradient=False)
        d = (x * 2.0).detach()
        (d * x).sum().backward()
        return x.grad
    np.testing.assert_allclose(both(s).numpy(), [2.0, 4.0])


def test_multi_output_op_grad():
    def s(m):
        x = m.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                        stop_gradient=False)
        a, b, c = m.ops.split(x, 3, axis=1)
        (a * 1.0 + b * 2.0 + c * 3.0).sum().backward()
        return x.grad
    np.testing.assert_allclose(both(s).numpy(),
                               np.tile([1.0, 2.0, 3.0], (2, 1)))


def test_reductions_and_manip():
    a = _rng(5).randn(2, 3, 4).astype(np.float32)

    def s(m):
        t = m.to_tensor(a)
        return [t.sum(axis=1), t.mean(), t.reshape([6, 4]),
                t.transpose([2, 0, 1]), m.ops.concat([t, t], axis=0)]
    both(s)


def test_indexing_and_grad():
    def s(m):
        x = m.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4),
                        stop_gradient=False)
        x[1].sum().backward()
        return x.grad
    expected = np.zeros((3, 4), np.float32)
    expected[1] = 1.0
    np.testing.assert_allclose(both(s).numpy(), expected)


def test_comparison_and_logical():
    def s(m):
        a = m.to_tensor([1.0, 2.0, 3.0])
        b = m.to_tensor([2.0, 2.0, 2.0])
        return [a > b, a == b, (a > b) & (a == b), ~(a > b)]
    got = both(s)
    np.testing.assert_array_equal(got[0].numpy(), [False, False, True])


def test_pylayer_custom_backward():
    def s(m):
        class Double(m.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * 2.0

            @staticmethod
            def backward(ctx, grad):
                (x,) = ctx.saved_tensor()
                return grad * 100.0 + x * 0.0

        x = m.to_tensor([1.0], stop_gradient=False)
        y = Double.apply(x)
        y.backward()
        return [y, x.grad]
    np.testing.assert_allclose(both(s)[1].numpy(), [100.0])


def test_pylayer_two_outputs_and_saved_tensors_hooks():
    packed = []

    def s(m):
        class Split(m.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k):
                ctx.save_for_backward(x)
                return x * k, x + 1.0

            @staticmethod
            def backward(ctx, ga, gb):
                (x,) = ctx.saved_tensor()
                return ga * 3.0 + gb * x

        x = m.to_tensor([1.0, 2.0], stop_gradient=False)
        with m.autograd.saved_tensors_hooks(
                lambda t: packed.append(1) or t, lambda t: t):
            a, b = Split.apply(x, 3.0)
        (a + b * b).sum().backward()
        return [a, b, x.grad]
    both(s)
    assert packed == [1, 1]


def test_autograd_grad_api():
    def s(m):
        x = m.to_tensor([3.0], stop_gradient=False)
        (g,) = m.autograd.grad(x * x, x)
        assert x.grad is None
        return g
    np.testing.assert_allclose(both(s).numpy(), [6.0])


def test_autograd_grad_unused_input():
    def s(m):
        x = m.to_tensor([3.0], stop_gradient=False)
        z = m.to_tensor([1.0, 2.0], stop_gradient=False)
        gx, gz = m.grad(x * x, [x, z])
        assert m.grad(x * x, [z], allow_unused=True) == [None]
        return [gx, gz]
    both(s)


def test_vjp_jvp_jacobian_hessian():
    a = _rng(6).randn(3).astype(np.float32)

    def f(x):
        return (x * x * x).sum() + x[0] * x[1]

    def g(x):
        return x.exp() * 2.0

    def s(m):
        x = m.to_tensor(a)
        out, vj = m.autograd.vjp(g, x)
        out2, jv = m.autograd.jvp(g, x)
        jac = m.autograd.jacobian(g, x)
        hes = m.autograd.hessian(f, x)
        return [out, vj, out2, jv, jac, hes]
    both(s, atol=1e-4, rtol=1e-5)


def test_random_ops_wait_for_item_15_2():
    """The random ops of item 15.2 are in: ``randn`` and
    ``Tensor.uniform_`` under one seed draw the reference's values
    (uniform bit for bit, normal within 3 ulps)."""
    def s(m):
        m.seed(5)
        a = m.ops.randn([4])
        b = m.to_tensor([1.0, 2.0, 3.0]).uniform_(-2.0, 2.0)
        return [a, b]
    got, want = s(pt), s(jt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0].numpy()),
                               rtol=4e-7, atol=0)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1].numpy()))


def test_cast_astype():
    def s(m):
        x = m.to_tensor([1.5, 2.5])
        i = x.astype("int32")
        b = x.astype(m.bfloat16)
        assert b.dtype == m.bfloat16
        return [i, b.astype("float32")]
    both(s)


class TestRegisterHook:
    def test_leaf_hook_scales_grad(self):
        def s(m):
            x = m.to_tensor([1.0, 2.0], stop_gradient=False)
            x.register_hook(lambda g: g * 2)
            (x * x).sum().backward()
            return x.grad
        np.testing.assert_allclose(both(s).numpy(), [4.0, 8.0])

    def test_leaf_hook_called_once_with_accumulated_grad(self):
        def s(m):
            calls = []
            x = m.to_tensor([3.0], stop_gradient=False)
            x.register_hook(lambda g: calls.append(g.numpy().copy()))
            (x * x + x * 4.0).backward()
            assert len(calls) == 1
            return [calls[0], x.grad]
        np.testing.assert_allclose(both(s)[0], [10.0])

    def test_intermediate_hook_rewrites_cotangent(self):
        def s(m):
            x = m.to_tensor([2.0], stop_gradient=False)
            h = x * 3.0
            h.register_hook(lambda g: g * 10)
            (h * h).backward()
            return x.grad
        np.testing.assert_allclose(both(s).numpy(), [360.0])

    def test_none_return_keeps_grad(self):
        def s(m):
            seen = []
            x = m.to_tensor([5.0], stop_gradient=False)
            x.register_hook(lambda g: seen.append(float(g.numpy()[0])))
            (x * 7.0).backward()
            assert seen == [7.0]
            return x.grad
        both(s)

    def test_remove_handle(self):
        def s(m):
            x = m.to_tensor([1.0], stop_gradient=False)
            handle = x.register_hook(lambda g: g * 100)
            assert handle.remove()
            assert not handle.remove()
            (x * 2.0).backward()
            return x.grad
        np.testing.assert_allclose(both(s).numpy(), [2.0])

    def test_stop_gradient_rejected(self):
        for m in (jt, pt):
            with pytest.raises(RuntimeError):
                m.to_tensor([1.0]).register_hook(lambda g: g)

    def test_no_phantom_hook_on_unreached_output(self):
        def s(m):
            calls = []
            x = m.to_tensor([1.0, 2.0, 3.0, 4.0], stop_gradient=False)
            a, b = m.ops.split(x, 2)
            b.register_hook(lambda g: calls.append(1))
            a.sum().backward()
            assert calls == []
            return x.grad
        np.testing.assert_allclose(both(s).numpy(), [1, 1, 0, 0])

    def test_hook_survives_inplace_rebind(self):
        def s(m):
            calls = []
            x = m.to_tensor([1.0, 2.0], stop_gradient=False)
            x.register_hook(lambda g: calls.append(1) or g * 3)
            x.add_(m.to_tensor([1.0, 1.0]))
            x.sum().backward()
            assert calls == [1]
            return x
        both(s)

    def test_nonleaf_hook_survives_inplace_rebind(self):
        def s(m):
            seen = []
            x = m.to_tensor([2.0], stop_gradient=False)
            y = x * 2.0
            y.register_hook(lambda g: seen.append(float(g.numpy()[0])))
            y.add_(m.to_tensor([1.0]))
            (y * 3.0).sum().backward()
            assert seen == [3.0]
            return x.grad
        np.testing.assert_allclose(both(s).numpy(), [6.0])


# -------------------------------------------------------- test_ops_oracle.py


def x24(seed):
    return _rng(seed).uniform(-2, 2, (4, 6)).astype(np.float32)


def xpos(seed):
    return _rng(seed).uniform(0.3, 3, (4, 6)).astype(np.float32)


def xunit(seed):
    return _rng(seed).uniform(-0.9, 0.9, (4, 6)).astype(np.float32)


UNARY = [
    ("abs", x24, np.abs), ("exp", x24, np.exp), ("log", xpos, np.log),
    ("log2", xpos, np.log2), ("log10", xpos, np.log10),
    ("log1p", xpos, np.log1p), ("sqrt", xpos, np.sqrt),
    ("rsqrt", xpos, lambda v: 1 / np.sqrt(v)), ("square", x24, np.square),
    ("sin", x24, np.sin), ("cos", x24, np.cos), ("tan", xunit, np.tan),
    ("asin", xunit, np.arcsin), ("acos", xunit, np.arccos),
    ("atan", x24, np.arctan), ("sinh", x24, np.sinh),
    ("cosh", x24, np.cosh), ("tanh", x24, np.tanh),
    ("asinh", x24, np.arcsinh),
    ("acosh", lambda s: _rng(s).uniform(1.1, 3, (4, 6)).astype(np.float32),
     np.arccosh),
    ("atanh", xunit, np.arctanh), ("ceil", x24, np.ceil),
    ("floor", x24, np.floor), ("round", x24, np.round),
    ("trunc", x24, np.trunc), ("sign", x24, np.sign),
    ("neg", x24, np.negative), ("reciprocal", xpos, np.reciprocal),
    ("sigmoid", x24, lambda v: 1 / (1 + np.exp(-v))),
    ("erf", x24, sps.erf), ("expm1", x24, np.expm1),
    ("lgamma", xpos, sps.gammaln), ("digamma", xpos, sps.digamma),
    ("frac", x24, lambda v: v - np.trunc(v)),
    ("relu", x24, lambda v: np.maximum(v, 0)),
    ("logit", lambda s: _rng(s).uniform(0.1, 0.9, (4, 6)).astype(
        np.float32), sps.logit),
]


@pytest.mark.parametrize("name,gen,ref", UNARY, ids=[u[0] for u in UNARY])
def test_unary_oracle(name, gen, ref):
    x = gen(len(name))
    got = both(lambda m: getattr(m, name)(m.to_tensor(x)), atol=2e-5,
               rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref(x), atol=2e-5, rtol=2e-5)


BINARY = [
    ("add", np.add), ("subtract", np.subtract), ("multiply", np.multiply),
    ("divide", np.divide), ("maximum", np.maximum), ("minimum", np.minimum),
    ("pow", np.power), ("atan2", np.arctan2), ("fmax", np.fmax),
    ("fmin", np.fmin), ("hypot", np.hypot), ("logaddexp", np.logaddexp),
    ("heaviside", np.heaviside), ("copysign", np.copysign),
]


@pytest.mark.parametrize("name,ref", BINARY, ids=[b[0] for b in BINARY])
def test_binary_oracle(name, ref):
    a, b = x24(10), x24(11)
    tol = 1e-5
    if name == "pow":
        a, tol = np.abs(a) + 0.5, 1e-4
    if name == "divide":
        b = np.where(np.abs(b) < 0.3, 0.7, b).astype(np.float32)
    got = both(lambda m: getattr(m, name)(m.to_tensor(a), m.to_tensor(b)),
               atol=tol, rtol=tol)
    np.testing.assert_allclose(got.numpy(), ref(a, b), atol=tol, rtol=tol)


def test_binary_broadcast():
    a = x24(12)
    b = _rng(13).uniform(-1, 1, (6,)).astype(np.float32)

    def s(m):
        return [m.add(m.to_tensor(a), m.to_tensor(b)),
                m.multiply(m.to_tensor(a.reshape(4, 6, 1)),
                           m.to_tensor(b.reshape(1, 6)[:, :, None]))]
    got = both(s)
    np.testing.assert_allclose(got[0].numpy(), a + b, rtol=1e-6)


REDUCE = [("sum", np.sum), ("mean", np.mean), ("max", np.max),
          ("min", np.min), ("prod", np.prod)]


@pytest.mark.parametrize("name,ref", REDUCE, ids=[r[0] for r in REDUCE])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_reduce_oracle(name, ref, axis):
    x = xpos(20) * 0.5
    attrs = {} if axis is None else {"axis": axis}
    got = both(lambda m: getattr(m, name)(m.to_tensor(x), **attrs),
               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref(x, **({} if axis is None
                                                      else {"axis": axis})),
                               atol=1e-4, rtol=1e-4)


def test_reduce_keepdim_variance_std():
    x = x24(21)

    def s(m):
        t = m.to_tensor(x)
        return [m.var(t, unbiased=False), m.std(t, axis=1, keepdim=True),
                m.logsumexp(t, axis=-1)]
    got = both(s, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(),
                               np.std(x, axis=1, ddof=1, keepdims=True),
                               atol=1e-4)


MANIP = [
    ("reshape", {"shape": [6, 4]}), ("transpose", {"perm": [1, 0]}),
    ("flip", {"axis": 0}), ("roll", {"shifts": 2, "axis": 1}),
    ("tile", {"repeat_times": [2, 1]}), ("squeeze", {}),
    ("cumsum", {"axis": 1}), ("cumprod", {"dim": 1}), ("tril", {}),
    ("triu", {}),
]


@pytest.mark.parametrize("name,attrs", MANIP, ids=[m[0] for m in MANIP])
def test_manip_oracle(name, attrs):
    x = x24(30) if name != "squeeze" else x24(30).reshape(4, 1, 6)
    both(lambda m: getattr(m, name)(m.to_tensor(x), **attrs))


def test_concat_stack_split():
    a, b = x24(31), x24(32)

    def s(m):
        ta, tb = m.to_tensor(a), m.to_tensor(b)
        return [m.concat([ta, tb], axis=0), m.stack([ta, tb], axis=1),
                list(m.split(ta, 2, axis=1))]
    both(s)


def test_indexing_ops():
    x = x24(33)
    idx = np.array([2, 0, 3], dtype=np.int64)

    def s(m):
        t = m.to_tensor(x)
        return [m.index_select(t, m.to_tensor(idx), axis=0),
                m.gather(t, m.to_tensor(idx)),
                m.take_along_axis(t, m.to_tensor(np.argsort(x, 1)), 1)]
    got = both(s)
    np.testing.assert_allclose(got[2].numpy(), np.sort(x, 1), atol=1e-6)


def test_linalg_oracle():
    a = _rng(34).uniform(-1, 1, (3, 4)).astype(np.float32)
    b = _rng(35).uniform(-1, 1, (4, 5)).astype(np.float32)
    v = _rng(36).uniform(-1, 1, (4,)).astype(np.float32)
    sq = _rng(37).uniform(-1, 1, (3, 3)).astype(np.float32) + 3 * np.eye(
        3, dtype=np.float32)

    def s(m):
        return [m.matmul(m.to_tensor(a), m.to_tensor(b)),
                m.mv(m.to_tensor(a), m.to_tensor(v)),
                m.inverse(m.to_tensor(sq)), m.det(m.to_tensor(sq)),
                m.trace(m.to_tensor(sq))]
    got = both(s, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.linalg.inv(sq), atol=1e-3)


GRAD_CASES = [
    ("tanh", x24, {}), ("exp", xunit, {}), ("log", xpos, {}),
    ("sqrt", xpos, {}), ("sigmoid", x24, {}), ("square", x24, {}),
    ("mean", x24, {"axis": 1}), ("sum", x24, {"axis": 0}),
    ("softmax", x24, {"axis": -1}), ("reshape", x24, {"shape": [6]}),
    ("transpose", x24, {"perm": [1, 0]}),
]


def _fd_grad(op, x, attrs, weight, eps=1e-3):
    """Central differences of sum(op(x) * weight) in the port, in f64."""
    base = x.astype(np.float64)
    num = np.zeros_like(base)
    flat, gnum = base.reshape(-1), num.reshape(-1)
    for j in range(flat.size):
        for sgn in (+1, -1):
            pert = flat.copy()
            pert[j] += sgn * eps
            out = op(pt.to_tensor(pert.reshape(x.shape).astype(np.float32)),
                     **attrs)
            gnum[j] += sgn * float((out * pt.to_tensor(weight)).sum())
        gnum[j] /= 2 * eps
    return num


@pytest.mark.parametrize("name,gen,attrs", GRAD_CASES,
                         ids=[g[0] for g in GRAD_CASES])
def test_grad_finite_difference(name, gen, attrs):
    x = gen(40)[:2, :3]

    def s(m):
        t = m.to_tensor(x, stop_gradient=False)
        out = getattr(m, name)(t, **attrs)
        w = _rng(0).uniform(0.5, 1.5, out.shape).astype(np.float32)
        (out * m.to_tensor(w)).sum().backward()
        return [t.grad, w]
    got, w = both(s)
    num = _fd_grad(getattr(pt, name), x, attrs, w)
    np.testing.assert_allclose(got.numpy(), num, atol=5e-3, rtol=5e-3)


def test_grad_binary_matmul():
    a = _rng(41).uniform(-1, 1, (2, 3)).astype(np.float32)
    b = _rng(42).uniform(-1, 1, (3, 2)).astype(np.float32)

    def s(m):
        out = []
        for op, x, y in ((m.matmul, a, b), (m.multiply, a, a + 1),
                         (m.divide, a, np.abs(b.T) + 1)):
            tx = m.to_tensor(x, stop_gradient=False)
            ty = m.to_tensor(y, stop_gradient=False)
            op(tx, ty).sum().backward()
            out += [tx.grad, ty.grad]
        return out
    both(s)


# ------------------------------------------------------ where torch differs


def test_canonical_dtypes():
    def s(m):
        i = m.to_tensor(np.arange(3))
        f = m.to_tensor(np.ones(2), dtype="float64")
        am = m.argmax(m.to_tensor(np.array([1.0, 3.0, 2.0], np.float32)))
        si = m.sum(i)
        return [i, f, am, si, m.to_tensor(np.arange(3)).astype("int64"),
                m.cumsum(i), m.mean(i), m.to_tensor([True, False]).sum(),
                m.arange(5), m.arange(0.0, 1.0, 0.25)]
    got = both(s)
    assert [dtype_name(g.dtype) for g in got[:4]] == \
        ["int32", "float32", "int32", "int32"]


def test_stop_gradient_and_grad_attributes():
    def s(m):
        x = m.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 3.0
        assert not y.stop_gradient and not y.is_leaf and y.grad is None
        y.stop_gradient = True          # cuts the graph at y
        z = (y * x).sum()
        z.backward()
        g = x.grad.numpy().copy()
        x.clear_grad()
        assert x.grad is None
        n = m.to_tensor([1, 2])
        n.stop_gradient = False         # accepted on an integer tensor
        assert not n.stop_gradient
        return g
    np.testing.assert_allclose(both(s), [3.0, 6.0])


def test_backward_without_a_graph_is_a_no_op():
    def s(m):
        x = m.to_tensor([1.0, 2.0])
        (x * 2.0).sum().backward()
        return x.grad
    assert both(s) is None


class TestInplaceVariants:
    def test_add_(self):
        def s(m):
            x = m.to_tensor(np.array([1.0, 2.0], np.float32))
            y = x.add_(m.to_tensor(np.array([10.0, 20.0], np.float32)))
            assert y is x
            return x
        np.testing.assert_allclose(both(s).numpy(), [11.0, 22.0])

    def test_clip_scale_chain(self):
        def s(m):
            x = m.to_tensor(np.array([-5.0, 0.5, 5.0], np.float32))
            x.clip_(min=-1.0, max=1.0).scale_(scale=2.0)
            return x
        np.testing.assert_allclose(both(s).numpy(), [-2.0, 1.0, 2.0])

    def test_cast_changes_dtype(self):
        def s(m):
            x = m.to_tensor(np.array([1.7], np.float32))
            x.cast_("int32")
            return x
        assert dtype_name(both(s).dtype) == "int32"

    def test_zero_fill(self):
        def s(m):
            x = m.to_tensor(np.ones((2, 2), np.float32))
            x.zero_()
            a = x.numpy().copy()
            x.fill_(3.5)
            return [a, x]
        both(s)

    def test_zero_detaches_tape(self):
        def s(m):
            a = m.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
            b = m.to_tensor(np.array([3.0], np.float32), stop_gradient=False)
            y = a * b
            y.zero_()
            (y + a).sum().backward()
            assert b.grad is None
            return a.grad
        np.testing.assert_allclose(both(s).numpy(), [1.0])

    def test_exp_sqrt_(self):
        def s(m):
            x = m.to_tensor(np.array([4.0], np.float32))
            x.sqrt_()
            a = x.numpy().copy()
            x.exp_()
            return [a, x]
        both(s, rtol=1e-6)

    def test_inplace_participates_in_autograd(self):
        def s(m):
            a = m.to_tensor(np.array([-2.0, 3.0], np.float32),
                            stop_gradient=False)
            b = m.to_tensor(np.array([5.0, 7.0], np.float32),
                            stop_gradient=False)
            y = a * b
            y.relu_()
            y.sum().backward()
            return [a.grad, b.grad]
        np.testing.assert_allclose(both(s)[0].numpy(), [0.0, 7.0])

    def test_inplace_on_a_leaf_leaves_the_leaf_unmutated(self):
        """x.add_ rebinds x; the torch leaf it held is not written."""
        x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
        leaf = x.value
        x.add_(pt.to_tensor([1.0, 1.0]))
        np.testing.assert_allclose(leaf.detach().numpy(), [1.0, 2.0])
        assert not x.is_leaf and leaf.is_leaf

    def test_squeeze_unsqueeze_reshape_(self):
        def s(m):
            x = m.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3, 1))
            x.squeeze_(-1)
            a = x.shape
            x.unsqueeze_(0)
            b = x.shape
            x.reshape_([3, 2])
            return [np.array(a), np.array(b), x]
        both(s)


class TestReviewRegressions:
    def test_cummax_indices(self):
        def s(m):
            vals, idx = m.cummax(m.to_tensor(np.array([3.0, 1.0, 5.0, 5.0],
                                                      np.float32)), axis=0)
            return [vals, idx]
        np.testing.assert_array_equal(both(s)[1].numpy(), [0, 0, 2, 2])

    def test_cummin_indices_2d(self):
        x = np.array([[2.0, 1.0], [0.5, 3.0], [0.5, 0.0]], np.float32)

        def s(m):
            return list(m.cummin(m.to_tensor(x), axis=0))
        np.testing.assert_array_equal(both(s)[1].numpy(),
                                      [[0, 0], [1, 0], [1, 2]])

    def test_cummax_gradient_goes_to_the_first_of_ties(self):
        def s(m):
            x = m.to_tensor(np.array([1.0, 4.0, 4.0, 2.0], np.float32),
                            stop_gradient=False)
            m.cummax(x, axis=0)[0].sum().backward()
            return x.grad
        np.testing.assert_allclose(both(s).numpy(), [1.0, 3.0, 0.0, 0.0])

    def test_vector_norm_keepdim_all_axes(self):
        def s(m):
            return m.vector_norm(m.to_tensor(np.ones((2, 3), np.float32)),
                                 keepdim=True)
        assert tuple(both(s).shape) == (1, 1)


class TestIndexing:
    def test_out_of_range_index_clamps(self):
        x = np.arange(5, dtype=np.float32)

        def s(m):
            t = m.to_tensor(x)
            return [t[7], t[-7], t[m.to_tensor(np.array([1, 9]))],
                    t[2:9], t[::-1], t[::-2]]
        got = both(s)
        np.testing.assert_allclose(got[0].numpy(), 4.0)

    def test_multi_axis_and_tensor_indices(self):
        x = _rng(50).randn(3, 4, 5).astype(np.float32)

        def s(m):
            t = m.to_tensor(x)
            i = m.to_tensor(np.array([0, 2]))
            return [t[1, :, 2], t[..., 1], t[:, None, 1], t[i], t[:, i, 1:3],
                    t[t > 0], t[1:, -1]]
        both(s)

    def test_getitem_gradient_with_repeats(self):
        def s(m):
            x = m.to_tensor(np.arange(4, dtype=np.float32),
                            stop_gradient=False)
            x[m.to_tensor(np.array([1, 1, 3]))].sum().backward()
            return x.grad
        np.testing.assert_allclose(both(s).numpy(), [0, 2, 0, 1])

    def test_setitem_rebinds_and_keeps_the_producer(self):
        """The reference rebinds the value and keeps the tape node: the
        gradient passes to the producer unchanged, the overwritten slots
        included, and the stored value gets none."""
        def s(m):
            x = m.to_tensor(np.array([1.0, 2.0, 3.0], np.float32),
                            stop_gradient=False)
            y = x * 2.0
            y[1] = 10.0
            y[7] = 99.0                 # out of range: dropped
            (y * y).sum().backward()
            return [y, x.grad]
        got = both(s)
        np.testing.assert_allclose(got[0].numpy(), [2.0, 10.0, 6.0])

    def test_setitem_on_a_leaf_keeps_it_a_leaf(self):
        def s(m):
            w = m.to_tensor(np.zeros(3, np.float32), stop_gradient=False)
            w[0] = 5.0
            assert w.is_leaf and not w.stop_gradient
            (w * w).sum().backward()
            w[m.to_tensor(np.array([1, 2]))] = m.to_tensor(
                np.array([7.0, 8.0], np.float32))
            return [w, w.grad]
        both(s)


class TestKinksAndTies:
    @pytest.mark.parametrize("op", ["abs", "relu", "sqrt"])
    def test_at_zero(self, op):
        def s(m):
            x = m.to_tensor(np.array([0.0, 1.0], np.float32),
                            stop_gradient=False)
            getattr(m, op)(x).sum().backward()
            return x.grad
        both(s)

    def test_norm_at_zero(self):
        def s(m):
            x = m.to_tensor(np.zeros(3, np.float32), stop_gradient=False)
            y = m.to_tensor(np.array([0.0, 2.0], np.float32),
                            stop_gradient=False)
            m.norm(x).backward()
            m.norm(y, p=1).backward()
            return [x.grad, y.grad]
        g = both(s)
        assert np.isnan(g[0].numpy()).all()

    @pytest.mark.parametrize("op", ["max", "min", "amax", "amin", "median"])
    def test_ties(self, op):
        def s(m):
            v = [1.0, 2.0, 2.0] if op in ("max", "amax") else \
                [2.0, 1.0, 1.0] if op in ("min", "amin") else \
                [1.0, 2.0, 2.0, 3.0, 2.0]
            x = m.to_tensor(np.array(v, np.float32), stop_gradient=False)
            getattr(m, op)(x).backward()
            return x.grad
        got = both(s)
        if op == "max":
            np.testing.assert_allclose(got.numpy(), [0.0, 0.5, 0.5])

    def test_ties_along_an_axis_and_even_median(self):
        x = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 5.0, 5.0]],
                     np.float32)

        def s(m):
            out = []
            for op in ("max", "min", "median"):
                t = m.to_tensor(x, stop_gradient=False)
                getattr(m, op)(t, axis=1).sum().backward()
                out.append(t.grad)
            return out
        both(s)

    def test_clip_and_maximum_at_a_bound(self):
        def s(m):
            x = m.to_tensor(np.array([-1.0, 0.0, 1.0], np.float32),
                            stop_gradient=False)
            y = m.to_tensor(np.array([-1.0, 5.0, 1.0], np.float32),
                            stop_gradient=False)
            (m.clip(x, -1.0, 1.0) + m.maximum(x, y)).sum().backward()
            return [x.grad, y.grad]
        both(s)


class TestAmpO1:
    def test_white_and_black_lists(self):
        a = _rng(60).randn(4, 8).astype(np.float32)
        b = _rng(61).randn(8, 3).astype(np.float32)

        def s(m):
            with m.amp.auto_cast(dtype="bfloat16"):
                ta, tb = m.to_tensor(a), m.to_tensor(b)
                mm = m.matmul(ta, tb)              # white: bf16
                ex = m.exp(mm)                     # black: f32
                ad = m.add(mm, mm)                 # neither: bf16 stays
            return [mm, ex, ad]
        got = both(s, atol=0.05, rtol=0.02)
        assert [dtype_name(g.dtype) for g in got] == \
            ["bfloat16", "float32", "bfloat16"]

    def test_functional_linear_under_auto_cast(self):
        x = _rng(62).randn(2, 8).astype(np.float32)
        w = _rng(63).randn(8, 4).astype(np.float32)

        def s(m):
            with m.amp.auto_cast(dtype="bfloat16"):
                return m.nn.functional.linear(m.to_tensor(x), m.to_tensor(w))
        got = both(s, atol=0.05, rtol=0.02)
        assert dtype_name(got.dtype) == "bfloat16"


class TestNanInfCheck:
    def test_raises_then_warns_then_off(self):
        for m in (jt, pt):
            setter = m.core.tensor.set_nan_inf_check
            try:
                setter(True)
                with pytest.raises(FloatingPointError, match="log"):
                    m.log(m.to_tensor(np.array([-1.0], np.float32)))
                setter("1", level=1)
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    m.log(m.to_tensor(np.array([-1.0], np.float32)))
                assert any("Inf/Nan" in str(x.message) for x in w)
            finally:
                setter(False)
            m.log(m.to_tensor(np.array([-1.0], np.float32)))


def test_numpy_of_bf16_is_float32_exactly():
    """Divergence (ROADMAP Queue 3): the reference returns ml_dtypes'
    bfloat16; the port copies out as float32, exactly (the card's host
    has no ml_dtypes)."""
    v = np.array([1.0, 1.0078125, -3.5, 1e-3], np.float32)
    x = pt.to_tensor(v, dtype="bfloat16")
    j = jt.to_tensor(v, dtype="bfloat16")
    got = x.numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(j.numpy(), np.float32))


class TestPinnedDivergences:
    """Where the port parts from the reference on purpose; each is a
    ROADMAP Queue 3 entry ("The tensor API")."""

    def test_integer_output_of_a_recorded_op_stops_gradient(self):
        x = np.array([1.0, 3.0, 2.0], np.float32)
        assert not jt.argmax(jt.to_tensor(x, stop_gradient=False)) \
            .stop_gradient
        assert pt.argmax(pt.to_tensor(x, stop_gradient=False)).stop_gradient

    def test_setitem_at_an_out_of_range_tensor_index_raises(self):
        j = jt.to_tensor(np.zeros(3, np.float32))
        j[jt.to_tensor(np.array([5]))] = 1.0            # dropped
        np.testing.assert_array_equal(j.numpy(), np.zeros(3))
        p = pt.to_tensor(np.zeros(3, np.float32))
        with pytest.raises(IndexError):
            p[pt.to_tensor(np.array([5]))] = 1.0
        np.testing.assert_array_equal(p.numpy(), np.zeros(3))

    def test_a_graph_built_before_a_leafs_rebind_feeds_the_old_value(self):
        def s(m):
            w = m.to_tensor(np.ones(2, np.float32), stop_gradient=False)
            z = (w * 3.0).sum()
            w.set_value(np.array([5.0, 5.0], np.float32))
            z.backward()
            return w.grad
        np.testing.assert_allclose(s(jt).numpy(), [3.0, 3.0])
        assert s(pt) is None

    def test_grad_with_respect_to_a_non_leaf(self):
        def s(m):
            a = m.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
            h = a * a
            return m.autograd.grad(h * 3.0, h)[0].numpy()
        np.testing.assert_allclose(s(jt), [0.0])     # the reference's gap
        np.testing.assert_allclose(s(pt), [3.0])

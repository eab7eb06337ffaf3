"""``jit.dy2static`` against the JAX package's, on the CPU.

The 23 cases of ``tests/test_dy2static.py``: each function (written in
``jnp`` for the reference and in ``torch`` for the port where the body
needs an array constructor) must agree converted and not, eagerly, and
with the reference's result; where the reference ``jax.jit``s the
converted function, the port ``torch.export``s it (``torch.cond`` and
``while_loop`` for a traced predicate) and runs the exported program.
The reference's raises stay raises: ``Dy2StaticError`` for a vector
predicate and for branches that do not match, under export. Then a
layer whose forward calls a ``to_static`` function with a
tensor-dependent ``if`` is saved by ``jit.save`` and its archive takes
both branches, and ``static.nn``'s control flow (``cond``,
``while_loop``, ``case``, ``switch_case``) gives the reference's values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu.jit.dy2static import convert_to_static as jconvert
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.jit.dy2static import Dy2StaticError
from paddle_tpu_torch.jit.dy2static import convert_to_static as tconvert
from paddle_tpu_torch.static import InputSpec


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _exported(fn, *args):
    """``fn`` exported with ``torch.export`` at ``args``, then run on
    them."""
    return torch.export.export(_Fn(fn), tuple(args)).module()(*args)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _agree(ref_fn, port_fn, *np_args, export_also=True):
    """The converted functions agree with the originals eagerly, the
    port's with the reference's, and the port's exported program with the
    reference's jitted one (rtol 1e-6)."""
    ref = ref_fn(*[np.asarray(a) for a in np_args])
    np.testing.assert_allclose(
        np.asarray(jconvert(ref_fn)(*[np.asarray(a) for a in np_args])),
        np.asarray(ref), rtol=1e-6)
    if export_also:
        ref = jax.jit(jconvert(ref_fn))(*[jnp.asarray(a) for a in np_args])
    static = tconvert(port_fn)
    targs = [_t(a) for a in np_args]
    np.testing.assert_allclose(port_fn(*targs).numpy(), np.asarray(ref),
                               rtol=1e-6)
    np.testing.assert_allclose(static(*targs).numpy(), np.asarray(ref),
                               rtol=1e-6)
    if export_also:
        np.testing.assert_allclose(_exported(static, *targs).numpy(),
                                   np.asarray(ref), rtol=1e-6)


def _f32(*v):
    return np.array(v, np.float32)


class TestIfElse:
    def test_simple_if(self):
        def f(x):
            y = x * 2
            if x.sum() > 0:
                y = y + 1
            else:
                y = y - 1
            return y

        _agree(f, f, _f32(1.0, 2.0))
        _agree(f, f, _f32(-1.0, -2.0))

    def test_if_without_else(self):
        def f(x):
            y = x
            if x.sum() > 0:
                y = y * 10
            return y

        _agree(f, f, _f32(3.0))
        _agree(f, f, _f32(-3.0))

    def test_nested_if(self):
        def f(x):
            y = x
            if x.sum() > 0:
                if x.sum() > 10:
                    y = y * 100
                else:
                    y = y * 10
            else:
                y = -y
            return y

        for v in (20.0, 5.0, -5.0):
            _agree(f, f, _f32(v))

    def test_python_bool_stays_python(self):
        def f(x, flag):
            y = x
            if flag:
                y = y + 1
            return y

        for conv, mk in ((jconvert, np.asarray), (tconvert, _t)):
            static = conv(f)
            np.testing.assert_allclose(
                np.asarray(static(mk(_f32(1.0)), True)), [2.0])
            np.testing.assert_allclose(
                np.asarray(static(mk(_f32(1.0)), False)), [1.0])


class TestLoops:
    def test_while_loop(self):
        def jf(x):
            i = jnp.asarray(0)
            s = x * 0
            while i < 5:
                s = s + x
                i = i + 1
            return s

        def tf(x):
            i = torch.tensor(0)
            s = x * 0
            while i < 5:
                s = s + x
                i = i + 1
            return s

        _agree(jf, tf, _f32(2.0))

    def test_while_data_dependent_bound(self):
        def f(x, n):
            s = x * 0
            i = n * 0
            while i < n:
                s = s + x
                i = i + 1
            return s

        want = jax.jit(jconvert(f))(jnp.asarray([3.0]), jnp.asarray(4))
        got = _exported(tconvert(f), torch.tensor([3.0]), torch.tensor(4))
        np.testing.assert_allclose(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(got.numpy(), [12.0])

    def test_for_range(self):
        def f(x):
            acc = x * 0
            for i in range(4):
                acc = acc + x * i
            return acc

        _agree(f, f, _f32(1.0, 2.0))

    def test_for_range_traced_bound(self):
        def f(x, n):
            acc = x * 0
            for i in range(n):
                acc = acc + x
            return acc

        want = jax.jit(jconvert(f))(jnp.asarray([5.0]), jnp.asarray(3))
        got = _exported(tconvert(f), torch.tensor([5.0]), torch.tensor(3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(got.numpy(), [15.0])


class TestLogical:
    def test_and_or_not(self):
        def f(x):
            a = x.sum() > 0
            b = x.sum() < 10
            y = x
            if a and b:
                y = y + 100
            if a or b:
                y = y + 1
            if not a:
                y = y - 1000
            return y

        for v in (5.0, 20.0, -5.0):
            _agree(f, f, _f32(v))


class TestToStaticIntegration:
    def test_to_static_with_control_flow(self):
        outs = {}
        for m in (jt, pt):
            @m.jit.to_static
            def relu_like(x):
                y = x
                if x.sum() > 0:
                    y = y * 2
                else:
                    y = y * 0
                return y

            outs[m.__name__] = [
                np.asarray(relu_like(m.to_tensor(_f32(*v))).numpy())
                for v in ((1.0, 2.0), (-1.0, -2.0))]
        for g, w, want in zip(outs["paddle_tpu_torch"], outs["paddle_tpu"],
                              ([2.0, 4.0], [0.0, 0.0])):
            np.testing.assert_allclose(g, w)
            np.testing.assert_allclose(g, want)

    def test_layer_with_loop_under_jit(self):
        def jbody(x, steps):
            acc = x * 0
            for i in range(steps):
                acc = acc + jnp.sin(x + i)
            return acc

        def tbody(x, steps):
            acc = x * 0
            for i in range(steps):
                acc = acc + torch.sin(x + i)
            return acc

        ref = jbody(np.asarray([0.5], np.float32), 3)
        want = jax.jit(jconvert(jbody))(jnp.asarray([0.5]), jnp.asarray(3))
        np.testing.assert_allclose(np.asarray(want), np.asarray(ref),
                                   rtol=1e-5)
        got = _exported(tconvert(tbody), torch.tensor([0.5]),
                        torch.tensor(3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(
            tconvert(tbody)(torch.tensor([0.5]), 3).numpy(),
            np.asarray(ref), rtol=1e-5)

    def test_mismatched_branches_raise_clearly(self):
        def jf(x):
            if x.sum() > 0:
                y = jnp.ones((2,))
            else:
                y = jnp.ones((3,))
            return y

        def tf(x):
            if x.sum() > 0:
                y = torch.ones(2)
            else:
                y = torch.ones(3)
            return y

        with pytest.raises(Exception):
            jax.jit(jconvert(jf))(jnp.asarray([1.0]))
        with pytest.raises(Dy2StaticError, match="mismatched"):
            _exported(tconvert(tf), torch.tensor([1.0]))

    def test_scalar_pred_requirement(self):
        def f(x):
            y = x
            if x > 0:  # vector predicate
                y = y + 1
            return y

        with pytest.raises(Exception, match="scalar"):
            jax.jit(jconvert(f))(jnp.asarray([1.0, -1.0]))
        with pytest.raises(Dy2StaticError, match="scalar"):
            _exported(tconvert(f), torch.tensor([1.0, -1.0]))


class TestNewTransformers:
    def test_ifexp_traced(self):
        def f(x):
            return (x * 2 if x.sum() > 0 else x * 3) + 1

        _agree(f, f, _f32(1.0, 2.0))
        _agree(f, f, _f32(-1.0, -2.0))

    def test_assert_eager_raises(self):
        def f(x):
            assert x.sum() > 0, "negative!"
            return x

        for conv, mk in ((jconvert, np.asarray), (tconvert, _t)):
            static = conv(f)
            np.testing.assert_allclose(np.asarray(static(mk(_f32(1.0)))),
                                       [1.0])
            with pytest.raises(AssertionError, match="negative"):
                static(mk(_f32(-1.0)))

    def test_assert_traced_is_noop(self):
        def f(x):
            assert x.sum() > -1e9
            return x * 2

        want = jax.jit(jconvert(f))(jnp.array([2.0], jnp.float32))
        got = _exported(tconvert(f), torch.tensor([2.0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(got.numpy(), [4.0])

    def test_print_traced_compiles(self, capfd):
        def f(x):
            print(x)
            return x + 1

        want = jax.jit(jconvert(f))(jnp.array([1.0], jnp.float32))
        got = _exported(tconvert(f), torch.tensor([1.0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want))

    def test_print_eager_passthrough(self, capsys):
        def f(x):
            print("value:", x)
            return x

        for conv, mk in ((jconvert, np.asarray), (tconvert, _t)):
            conv(f)(mk(_f32(5.0)))
            assert "value:" in capsys.readouterr().out

    def test_ifexp_tuple_branches_traced(self):
        def f(x):
            a, b = (x * 2, x + 1) if x.sum() > 0 else (x * 3, x - 1)
            return a + b

        want = jax.jit(jconvert(f))(jnp.array([1.0], jnp.float32))
        got = _exported(tconvert(f), torch.tensor([1.0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(got.numpy(), [4.0])
        got = _exported(tconvert(f), torch.tensor([-1.0]))
        np.testing.assert_allclose(got.numpy(), [-5.0])

    def test_print_label_and_tensor_traced(self, capsys):
        def f(x):
            print("loss:", x)
            return x * 2

        want = jax.jit(jconvert(f))(jnp.array([3.0], jnp.float32))
        got = _exported(tconvert(f), torch.tensor([3.0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want))
        assert "loss:" in capsys.readouterr().out


def test_print_shadowing_not_rewritten():
    """A local binding of ``print`` wins over the convert_print rewrite."""
    for m in (jt, pt):
        collected = []

        @m.jit.to_static
        def fn(x):
            print = collected.append   # noqa: A001 - deliberate shadow
            print(7)
            return x * 2

        np.testing.assert_allclose(fn(m.to_tensor([3.0])).numpy(), [6.0])
        assert collected == [7]


def test_assert_message_lazy():
    """assert messages evaluate only on failure (Python semantics)."""
    for m in (jt, pt):
        errors = []

        @m.jit.to_static
        def fn(x):
            assert True, f"err: {errors[0]}"   # IndexError if evaluated
            return x + 1

        np.testing.assert_allclose(fn(m.to_tensor([1.0])).numpy(), [2.0])


def test_print_with_keywords_converted(capsys):
    """print(..., flush=True) still routes through convert_print."""
    for m in (jt, pt):
        @m.jit.to_static
        def fn(x):
            print("val:", 3, flush=True)
            return x * 2

        np.testing.assert_allclose(fn(m.to_tensor([2.0])).numpy(), [4.0])
        assert "val: 3" in capsys.readouterr().out


def test_a_saved_layer_keeps_its_converted_branches(tmp_path):
    """``jit.save`` of a layer whose forward calls a ``to_static``
    function with a tensor-dependent ``if``: the archive holds a
    ``torch.cond`` and takes each branch where the eager layer does."""
    @pt.jit.to_static
    def gate(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y

    class Gate(pt.nn.Layer):
        def forward(self, x):
            return gate(x)

    layer = Gate()
    prefix = str(tmp_path / "gate")
    pt.jit.save(layer, prefix, input_spec=[InputSpec([-1, 3], "float32")])
    loaded = pt.jit.load(prefix, device="cpu")
    ops = {str(n.target) for n in loaded.program.graph.nodes}
    assert any("cond" in o for o in ops), ops
    for sign, bs in ((1.0, 2), (-1.0, 4)):
        x = sign * np.abs(np.random.default_rng(bs).standard_normal(
            (bs, 3))).astype(np.float32)
        (got,) = loaded(x) if isinstance(loaded(x), tuple) else (loaded(x),)
        want = layer(torch.as_tensor(x))
        assert torch.equal(got, want)


def test_static_nn_control_flow():
    """``static.nn.cond`` / ``while_loop`` (through the converters) and
    ``case`` / ``switch_case`` on concrete predicates, as the
    reference's."""
    import paddle_tpu.static as jst
    import paddle_tpu_torch.static as tst
    outs = {}
    for m, st in ((jt, jst), (pt, tst)):
        x = m.to_tensor(_f32(1.0, -2.0, 3.0))
        res = [st.nn.cond(x.sum() > 0, lambda: x * 2.0, lambda: x * 3.0),
               st.nn.cond(x.sum() < 0, lambda: x * 2.0, lambda: x * 3.0)]
        i, s = st.nn.while_loop(lambda i, s: i < 4,
                                lambda i, s: (i + 1, s + x),
                                [m.to_tensor(np.int32(0)), x * 0.0])
        res += [s, i]
        res.append(st.nn.case([(x.sum() < 0, lambda: x * 10.0),
                               (x.sum() > 0, lambda: x * 20.0)],
                              default=lambda: x))
        res.append(st.nn.switch_case(m.to_tensor(np.int32(1)),
                                     {0: lambda: x, 1: lambda: x * 5.0},
                                     default=lambda: x * 0.0))
        outs[m.__name__] = [np.asarray(r.numpy(), np.float64) for r in res]
    for g, w in zip(outs["paddle_tpu_torch"], outs["paddle_tpu"]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_allclose(outs["paddle_tpu_torch"][2], [4.0, -8.0, 12.0])

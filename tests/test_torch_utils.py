"""The port's ``utils`` against the JAX package's, on the CPU.

- ``utils.enforce``: ``tests/test_enforce.py``'s four cases run on both
  packages (the same typed errors, hints, stack summary and helpers);
- ``utils.unique_name``: one counter for ``static``'s variables, ``nn``'s
  layer names and ``generate``: a script interleaving them gives the
  reference's names, in order; ``static.unique_name`` is the same
  generator;
- ``utils.cpp_extension``: ``tests/test_cpp_extension.py``'s seven cases
  on the same C source (the eager op on torch tensors and on paddle
  ``Tensor``s, under ``jit.to_static``, its gradient through a
  ``torch.autograd.Function``, the multi-input op, a missing symbol, a
  compile error, inside a train step), each against the reference's
  values; the default build directory is the port's own;
- ``deprecated``, ``try_import``, ``require_version`` (against the port's
  ``__version__``) and ``run_check`` on ``set_device("cpu")``.
"""
import os
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice

SRC = textwrap.dedent("""
    #include <cstdint>
    extern "C" void square_fwd(const float* x, long long n, float* y) {
        for (long long i = 0; i < n; ++i) y[i] = x[i] * x[i];
    }
    extern "C" void square_bwd(const float* x, const float* gy,
                               long long n, float* gx) {
        for (long long i = 0; i < n; ++i) gx[i] = 2.0f * x[i] * gy[i];
    }
    extern "C" void weighted_sum(const float** ins, const long long* sizes,
                                 int n_inputs, float* out) {
        for (long long i = 0; i < sizes[0]; ++i) {
            float acc = 0.0f;
            for (int k = 0; k < n_inputs; ++k) acc += ins[k][i];
            out[i] = acc;
        }
    }
""")


@pytest.fixture(scope="module")
def on_cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


@pytest.fixture(scope="module")
def exts(tmp_path_factory):
    """The test source built by both packages, each into a directory of
    this test."""
    from paddle_tpu.utils import cpp_extension as jcpp
    from paddle_tpu_torch.utils import cpp_extension as tcpp
    d = tmp_path_factory.mktemp("ext")
    src = d / "sq.cc"
    src.write_text(SRC)
    return (jcpp.load("test_sq_ext", [str(src)], build_directory=str(d)),
            tcpp.load("test_sq_ext", [str(src)], build_directory=str(d),
                      verbose=True))


# ------------------------------------------------------------- enforce

def _enforce(m):
    return m.utils.enforce


@pytest.mark.parametrize("m", [jt, pt], ids=["jax", "port"])
def test_typed_errors_taxonomy(m):
    E = _enforce(m)
    for cls in (E.InvalidArgumentError, E.NotFoundError, E.OutOfRangeError,
                E.UnimplementedError):
        with pytest.raises(E.EnforceNotMet) as e:
            raise cls("boom", hint="check your inputs")
        assert cls.error_type in str(e.value)
        assert "Hint" in str(e.value)
        assert "operator stack" in str(e.value)
        assert e.value.raw_message == "boom"


@pytest.mark.parametrize("m", [jt, pt], ids=["jax", "port"])
def test_enforce_helpers(m):
    E = _enforce(m)
    assert E.enforce(True)
    with pytest.raises(E.InvalidArgumentError):
        E.enforce(False, "must hold")
    assert E.enforce_eq(3, 3)
    with pytest.raises(E.InvalidArgumentError, match="expected 3"):
        E.enforce_eq(3, 4)
    assert E.enforce_gt(2, 1) and E.enforce_ge(2, 2)
    with pytest.raises(E.InvalidArgumentError):
        E.enforce_gt(1, 2)


@pytest.mark.parametrize("m", [jt, pt], ids=["jax", "port"])
def test_enforce_shape_wildcards(m):
    E = _enforce(m)
    x = np.zeros((5, 3, 7))
    assert E.enforce_shape(x, [-1, 3, 7])
    assert E.enforce_shape(torch.zeros(5, 3, 7), [5, None, 7])
    with pytest.raises(E.InvalidArgumentError, match="shape mismatch"):
        E.enforce_shape(x, [5, 4, 7], name="weight")


@pytest.mark.parametrize("m", [jt, pt], ids=["jax", "port"])
def test_enforce_not_none(m):
    E = _enforce(m)
    assert E.enforce_not_none(0) == 0  # falsy but not None is fine
    with pytest.raises(E.NotFoundError):
        E.enforce_not_none(None, "scope var")


# --------------------------------------------------------- unique_name

def _names(m):
    un = m.utils.unique_name
    with un.guard():
        names = [un.generate("tmp_var")]
        main, startup = m.static.Program(), m.static.Program()
        with m.static.program_guard(main, startup):
            x = m.static.data("x", [2, 3])
            names.append(un.generate("tmp_var"))
            names.append((x * 2.0).name)
            names.append(m.static.nn.fc(x, 4).name)
            names.append(un.generate("fc"))
            names.append(m.static.create_parameter([3, 4], "float32").name)
            names.append(m.nn.Linear(3, 3).full_name())
            names.append(un.generate("linear"))
    return names


def test_static_nn_and_generate_share_one_counter(on_cpu):
    got, want = _names(pt), _names(jt)
    assert got == want
    assert got[:3] == ["tmp_var_0", "tmp_var_1", "multiply_0"]
    from paddle_tpu_torch.static import unique_name as static_un
    from paddle_tpu_torch.utils import unique_name as un
    assert static_un.generate is un.generate
    with un.guard("p_"):
        assert static_un.generate("k") == "p_k_0"


# ------------------------------------------------------- cpp_extension

def test_elementwise_op_forward(exts):
    jext, text = exts
    x = np.array([1.0, -2.0, 3.0], np.float32)
    want = np.asarray(jext.elementwise_op("square_fwd")(jnp.asarray(x)))
    got = text.elementwise_op("square_fwd")(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_elementwise_op_under_jit(exts, on_cpu):
    jext, text = exts
    jop, top = (e.elementwise_op("square_fwd") for e in exts)
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    want = np.asarray(jax.jit(lambda v: jop(v) + 1.0)(jnp.asarray(x)))

    @pt.jit.to_static
    def f(v):
        return top(v) + 1.0

    got = f(pt.to_tensor(x))
    assert isinstance(got, pt.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


def test_elementwise_op_grad(exts):
    jext, text = exts
    x = np.array([1.0, -2.0, 3.0], np.float32)
    jop = jext.elementwise_op("square_fwd", grad_symbol="square_bwd")
    want = np.asarray(jax.grad(lambda v: jop(v).sum())(jnp.asarray(x)))
    top = text.elementwise_op("square_fwd", grad_symbol="square_bwd")
    v = torch.tensor(x, requires_grad=True)
    top(v).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), want)
    nograd = text.elementwise_op("square_fwd")
    with pytest.raises(RuntimeError, match="not differentiable"):
        nograd(torch.tensor(x, requires_grad=True)).sum().backward()


def test_custom_multi_input_op(exts):
    jext, text = exts
    ins = [np.full((4,), v, np.float32) for v in (1.0, 2.0, 3.0)]
    want = np.asarray(jext.custom_op("weighted_sum", n_inputs=3)(
        *map(jnp.asarray, ins)))
    got = text.custom_op("weighted_sum", n_inputs=3)(
        *map(torch.from_numpy, ins))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), 6.0)


def test_missing_symbol_raises(exts):
    for ext in exts:
        with pytest.raises(AttributeError, match="no symbol"):
            ext.elementwise_op("nope_fn")


def test_compile_error_raises(tmp_path):
    from paddle_tpu_torch.utils import cpp_extension as cpp
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="compilation") as e:
        cpp.load("broken_ext", [str(src)], build_directory=str(tmp_path))
    assert "error" in str(e.value)              # g++'s own output
    assert [f for f in os.listdir(tmp_path) if f.endswith(".so")] == []


def test_integration_with_framework_autograd(exts, on_cpu):
    """Custom op inside a paddle train step: on a ``Tensor`` directly and
    through ``dispatch``, as the reference's test calls it."""
    from paddle_tpu_torch.core.tensor import dispatch
    op = exts[1].elementwise_op("square_fwd", grad_symbol="square_bwd")
    for call in (op, lambda v: dispatch(op, v, name="custom_square")):
        x = pt.to_tensor(np.array([1.0, 2.0], np.float32),
                         stop_gradient=False)
        y = call(x)
        assert isinstance(y, pt.Tensor)
        s = dispatch(lambda v: v.sum(), y, name="sum")
        s.backward()
        np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0])


def test_default_build_directory_is_the_ports(monkeypatch, tmp_path):
    from paddle_tpu_torch.utils import cpp_extension as cpp
    monkeypatch.delenv("PADDLE_EXTENSION_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert cpp.get_build_directory() == str(
        tmp_path / "paddle_tpu_torch_extensions")
    monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path / "mine"))
    assert cpp.get_build_directory() == str(tmp_path / "mine")
    with pytest.warns(UserWarning, match="host-side C"):
        ext = cpp.CUDAExtension(["a.cc"], name="cuda_ext")
    assert ext.name == "cuda_ext" and ext.sources == ["a.cc"]


# ------------------------------------------------------ the rest of utils

@pytest.mark.parametrize("m", [jt, pt], ids=["jax", "port"])
def test_deprecated_try_import_require_version(m):
    u = m.utils

    @u.deprecated(update_to="new_fn", since="0.1", reason="renamed")
    def old(x):
        return x + 1

    with pytest.warns(DeprecationWarning,
                      match="old is deprecated since 0.1, use new_fn "
                            "instead \\(renamed\\)"):
        assert old(1) == 2
    assert u.try_import("json").__name__ == "json"
    with pytest.raises(ImportError, match="no_such_mod"):
        u.try_import("no_such_mod")
    assert u.require_version("0.0.1") and u.require_version("0.1.0", "1.0")
    with pytest.raises(Exception, match="< required"):
        u.require_version("99.0")
    with pytest.raises(Exception, match="> allowed"):
        u.require_version("0.0.1", "0.0.2")


def test_run_check_on_the_cpu_place(on_cpu, capsys):
    pt.utils.run_check()
    assert "installed successfully" in capsys.readouterr().out


def test_run_check_with_more_than_one_card_raises(monkeypatch):
    """The reference's sharded matmul over several devices is item 13's
    mesh in the port: with more than one card, run_check raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(pt, "get_device", lambda: "gpu:0")
    place = tdevice._default[0]
    pt.set_device("cpu")                         # the step itself on the CPU
    try:
        with pytest.raises(NotImplementedError, match="item 13"):
            pt.utils.run_check()
    finally:
        tdevice._default[0] = place

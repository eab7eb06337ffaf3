"""The port's initializers, ``ParamAttr`` and ``create_parameter``
(``paddle_tpu_torch/nn/initializer.py``, ``param_attr.py``,
``layer.py``) against the JAX package's, on the CPU.

Each initializer draws under the same ``seed()`` as the reference: the
uniform family bit for bit, the normal family (Normal, TruncatedNormal,
XavierNormal, KaimingNormal) within 3 f32 ulps of the value (bf16 bit
for bit), Orthogonal within 1e-5 (its QR is LAPACK's through torch, the
reference's through XLA), the deterministic ones exactly; the next draw
after each is the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.initializer as TI
from paddle_tpu_torch import device as tdevice

NORMAL_ULPS = 3


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


@pytest.fixture
def no_global_init():
    yield
    JI.set_global_initializer(None, None)
    TI.set_global_initializer(None, None)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


UNIFORM = {
    "Uniform": lambda I: I.Uniform(-0.3, 0.7),
    "XavierUniform": lambda I: I.XavierUniform(),
    "XavierUniform_fans": lambda I: I.XavierUniform(fan_in=10, fan_out=3,
                                                    gain=2.0),
    "KaimingUniform": lambda I: I.KaimingUniform(),
    "KaimingUniform_leaky": lambda I: I.KaimingUniform(
        negative_slope=0.2, nonlinearity="leaky_relu"),
}
NORMAL = {
    "Normal": lambda I: I.Normal(0.5, 2.0),
    "TruncatedNormal": lambda I: I.TruncatedNormal(0.1, 0.02),
    "XavierNormal": lambda I: I.XavierNormal(),
    "KaimingNormal": lambda I: I.KaimingNormal(),
}
EXACT = {
    "Constant": lambda I: I.Constant(0.25),
    "Assign": lambda I: I.Assign(np.arange(60, dtype=np.float32).reshape(
        3, 4, 5)),
    "Bilinear": lambda I: I.Bilinear(),
    "Dirac": lambda I: I.Dirac(groups=3),
}
SHAPES = {"Bilinear": (3, 4, 5, 5), "Dirac": (6, 4, 3, 3),
          "Assign": (3, 4, 5)}


def _draw(name, make, dtype, seed=3):
    shape = SHAPES.get(name, (3, 4, 5))
    jt.seed(seed)
    want = make(JI)(shape, dtype)
    nj = np.asarray(jt.ops.rand([2]).numpy())
    pt.seed(seed)
    got = make(TI)(shape, dtype)
    npn = pt.ops.rand([2]).numpy()
    assert tuple(got.shape) == shape and got.device.type == "cpu"
    assert np.array_equal(nj, npn)
    return _f32(got), _f32(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(UNIFORM))
def test_uniform_initializers_are_bitwise(name, dtype):
    got, want = _draw(name, UNIFORM[name], dtype)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(NORMAL))
def test_normal_initializers_are_within_the_bound(name, dtype):
    got, want = _draw(name, NORMAL[name], dtype)
    if dtype == "bfloat16":
        assert np.array_equal(got, want)
    else:
        assert _ulps(got, want).max() <= NORMAL_ULPS


@pytest.mark.parametrize("name", sorted(EXACT))
def test_deterministic_initializers_are_exact(name):
    got, want = _draw(name, EXACT[name], "float32")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (4, 2, 3)], ids=str)
def test_orthogonal_matches(shape):
    jt.seed(2)
    want = np.asarray(JI.Orthogonal(gain=1.5)(shape))
    pt.seed(2)
    got = TI.Orthogonal(gain=1.5)(shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("args", [("relu",), ("tanh",), ("leaky_relu", 0.3),
                                  ("selu",), ("conv2d",)], ids=str)
def test_calculate_gain(args):
    assert TI.calculate_gain(*args) == JI.calculate_gain(*args)


def _layer_params(m, attr=None, bias_attr=None):
    lin = m.nn.Linear(5, 4, attr, bias_attr)
    return {n: _f32(p.numpy()) for n, p in lin.named_parameters()}, lin


def test_param_attr_initializer_name_rate_and_trainable():
    for m in (jt, pt):
        m.seed(4)
    jw, jl = _layer_params(jt, jt.ParamAttr(
        name="fc_w", initializer=JI.Uniform(-1, 1), learning_rate=0.1),
        jt.ParamAttr(trainable=False))
    tw, tl = _layer_params(pt, pt.ParamAttr(
        name="fc_w", initializer=TI.Uniform(-1, 1), learning_rate=0.1),
        pt.ParamAttr(trainable=False))
    for k in jw:
        assert np.array_equal(tw[k], jw[k]), k
    for a, b in ((tl.weight, jl.weight), (tl.bias, jl.bias)):
        assert a.name == b.name
        assert a.trainable == b.trainable
        assert a.stop_gradient == b.stop_gradient
        assert a.optimize_attr["learning_rate"] == \
            b.optimize_attr["learning_rate"]


def test_param_attr_to_attr():
    P = pt.ParamAttr
    assert P._to_attr(None) is None
    assert P._to_attr(False) is False
    assert P._to_attr("w").name == "w"
    init = TI.Constant(1.0)
    assert P._to_attr(init).initializer is init
    a = P(name="x")
    assert P._to_attr(a) is a


def test_global_initializer_overrides_a_default_not_an_attr(no_global_init):
    for m, I in ((jt, JI), (pt, TI)):
        I.set_global_initializer(I.Constant(0.5), I.Constant(-1.0))
    jw, _ = _layer_params(jt)
    tw, _ = _layer_params(pt)
    assert np.all(tw["weight"] == 0.5) and np.all(tw["bias"] == -1.0)
    for k in jw:
        assert np.array_equal(tw[k], jw[k]), k
    for m in (jt, pt):
        m.seed(6)
    jw, _ = _layer_params(jt, JI.Uniform(-2, 2))
    tw, _ = _layer_params(pt, TI.Uniform(-2, 2))
    assert np.array_equal(tw["weight"], jw["weight"])
    assert np.all(tw["bias"] == -1.0)
    assert TI.get_global_initializer() is not None
    assert TI.get_global_initializer(is_bias=True) is not None


def test_create_parameter():
    for m in (jt, pt):
        m.seed(8)
    want = jt.create_parameter([3, 4], "float32", name="cp")
    got = pt.create_parameter([3, 4], "float32", name="cp")
    assert got.name == "cp" and not got.stop_gradient
    assert isinstance(got, torch.nn.Parameter)
    assert _ulps(_f32(got.numpy()), _f32(want.numpy())).max() <= NORMAL_ULPS
    for m in (jt, pt):
        m.seed(8)
    want = jt.create_parameter([3], "float32", is_bias=True)
    got = pt.create_parameter([3], "float32", is_bias=True)
    assert np.array_equal(got.numpy(), np.asarray(want.numpy()))
    got = pt.create_parameter([2, 2], "float32",
                              default_initializer=TI.Constant(3.0))
    assert torch.equal(got.detach(), torch.full((2, 2), 3.0))

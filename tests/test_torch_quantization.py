"""The port's quantization (``paddle_tpu_torch.quantization``,
``nn.quant``) against the JAX package's, on the CPU, case by case with
``tests/test_quantization.py`` and ``tests/test_observers.py``.

Every case builds the same layers in both packages (the reference's
weights carried across by ``set_state_dict``), feeds the same numpy
inputs made from a seed, and holds the port to the reference:

- fake quant and the straight-through gradient bit for bit (f32), and
  the reference's type promotion: a bf16 tensor under an f32 scale tensor
  is quantized and returned in f32, under a Python scale in bf16; a bf16
  ``QuantedLinear`` under the activation quanter returns f32;
- the swaps of ``QAT`` / ``PTQ`` (by default, type, name and layer
  config; not twice; not in place), the channel axes of Linear, Conv2D
  and Conv2DTranspose, ``convert`` freezing the observers, and the
  swapped names of ``llama_tiny`` (every projection and the head);
- forwards of the quantized layers within ``TOL``, scales of the abs-max
  observers equal, the Hist / KL / MSE thresholds equal (the same
  float64 histograms on the host);
- ``to_int8_inference`` of a converted ``QuantedLinear``: the int8 codes
  and scales equal, outputs within one quantisation step;
- QAT training: losses of a small MLP and of ``llama_tiny`` (three AdamW
  steps) within ``TOL_STEP`` of the reference's, and the moving
  activation scales.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu import quantization as JQ
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import quantization as Q

TOL = 1e-5
# after optimizer steps: Adam moves a weight by ~lr * sign(g), so the
# f32 rounding of the two frameworks shows as a small fraction of a step
TOL_STEP = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def _carry(jl, tl):
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    missing, unexpected = tl.set_state_dict(sd)
    assert missing == [] and unexpected == [], (missing, unexpected)


def _pair(make):
    """``make(package)`` in both packages, the reference's weights in
    the port's layer."""
    jl, tl = make(jt), make(pt)
    _carry(jl, tl)
    return jl, tl


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
    v = x.numpy() if hasattr(x, "numpy") else x
    return np.asarray(v, np.float64)


def _tensor(q, a):
    """``a`` as the package of ``q``'s ``to_tensor``."""
    return (jt if q is JQ else pt).to_tensor(a)


def _kinds(model):
    return [type(m).__name__ for _, m in model.named_sublayers()]


def _quanted(model, kind="QuantedLinear"):
    return [n for n, m in model.named_sublayers() if type(m).__name__ == kind]


def _cfg(q, act=True, weight=True):
    return q.QuantConfig(
        activation=q.FakeQuanterWithAbsMaxObserver() if act else None,
        weight=q.FakeQuanterChannelWiseAbsMax() if weight else None)


# --------------------------------------------------------------- fake quant

@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_oracle(bits):
    import jax.numpy as jnp
    x = np.array([-1.0, -0.5, 0.0, 0.3, 1.0, 0.7, -2.0], np.float32)
    qmax = 2 ** (bits - 1) - 1
    got = Q.fake_quant(torch.tensor(x), 1.0, bits).numpy()
    ref = np.clip(np.round(x / 1.0 * qmax), -qmax, qmax) * 1.0 / qmax
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(
        got, np.asarray(JQ.fake_quant(jnp.asarray(x), 1.0, bits)))


def test_fake_quant_tensor_scales_equal_the_reference():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5)).astype(np.float32) * 3
    for scale in (np.float32(2.5), np.abs(x).max(0, keepdims=True)):
        got = Q.fake_quant(torch.tensor(x), torch.tensor(scale))
        want = JQ.fake_quant(jnp.asarray(x), jnp.asarray(scale))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fake_quant_promotes_as_jnp():
    """A bf16 x under a 0-d f32 scale tensor: f32 in both (torch alone
    would stay bf16); under a Python scale: bf16 in both; values
    equal."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    xf = rng.standard_normal(64).astype(np.float32)
    xb = torch.tensor(xf).bfloat16()
    jxb = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    got = Q.quant_dequant(xb, torch.tensor(2.0))
    want = JQ.quant_dequant(jxb, jnp.asarray(2.0, jnp.float32))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = Q.fake_quant(xb, 2.0)
    want = JQ.fake_quant(jxb, 2.0)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_quant_dequant_straight_through_grad():
    import jax
    import jax.numpy as jnp
    x = torch.tensor([0.3, -0.7], requires_grad=True)
    Q.quant_dequant(x, 1.0).sum().backward()
    want = jax.grad(lambda v: JQ.quant_dequant(v, 1.0).sum())(
        jnp.asarray([0.3, -0.7]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    xb = torch.tensor([0.3, -0.7]).bfloat16().requires_grad_()
    Q.quant_dequant(xb, torch.tensor(1.0)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(xb.grad.float().numpy(), [1.0, 1.0])


def test_bf16_quanted_linear_returns_f32():
    """Trouble spot 1: the reference's bf16 ``QuantedLinear`` under the
    moving abs-max activation quanter computes and returns f32; so does
    the port's, with the reference's values."""
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    jl, tl = _pair(lambda m: m.nn.Linear(16, 8))
    jl = jl.astype("bfloat16")      # the f32 weights rounded alike
    tl = tl.astype("bfloat16")
    jq = JQ.QuantedLinear(jl, _cfg(JQ)._default)
    tq = Q.QuantedLinear(tl, _cfg(Q)._default)
    jx = jt.to_tensor(jnp.asarray(x).astype(jnp.bfloat16))
    tx = torch.tensor(x).bfloat16()
    want, got = jq(jx), tq(tx)
    assert str(want.dtype).endswith("float32"), want.dtype
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(
        _np(tq.activation_quanter.scales()),
        _np(jq.activation_quanter.scales()))


# ------------------------------------------------------------------ swaps

def _mlp(m):
    return m.nn.Sequential(m.nn.Linear(8, 16), m.nn.ReLU(),
                           m.nn.Linear(16, 4))


def test_qat_quantize_swaps_linear():
    jm, tm = _pair(_mlp)
    jq = JQ.QAT(_cfg(JQ)).quantize(jm)
    tq = Q.QAT(_cfg(Q)).quantize(tm)
    assert _quanted(tq) == _quanted(jq) == ["0", "2"]
    assert _kinds(tq).count("QuantedLinear") == 2


@pytest.mark.parametrize("how", ["type", "name", "layer"])
def test_type_name_and_layer_config(how):
    def run(q, model):
        cfg = q.QuantConfig()
        w = q.FakeQuanterChannelWiseAbsMax()
        if how == "type":
            cfg.add_type_config(type(model[0]), weight=w)
        elif how == "name":
            cfg.add_name_config("1", weight=w)
        else:
            cfg.add_layer_config(model[0], weight=w)
        return _quanted(q.QAT(cfg).quantize(model))

    def two(m):
        return m.nn.Sequential(m.nn.Linear(4, 4), m.nn.Linear(4, 4))

    jm, tm = _pair(two)
    got, want = run(Q, tm), run(JQ, jm)
    assert got == want == {"type": ["0", "1"], "name": ["1"],
                           "layer": ["0"]}[how]


def test_layer_config_survives_the_deep_copy_on_a_plain_module():
    """Trouble spot 3: a plain ``torch.nn.Module`` has no
    ``full_name``; its config key is kept on it, so the copy made by
    ``quantize`` finds it, as a ``Layer``'s ``full_name`` is found."""

    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.ones(4, 3))
            self.bias = None

    model = torch.nn.Sequential(Plain(), Plain(), pt.nn.Linear(3, 3))
    cfg = Q.QuantConfig()
    cfg.add_qat_layer_mapping(Plain, Q.QuantedLinear)
    w = Q.FakeQuanterChannelWiseAbsMax()
    cfg.add_layer_config([model[1], model[2]], weight=w)
    swapped = Q.QAT(cfg).quantize(model)
    assert [type(m).__name__ for m in swapped] == ["Plain", "QuantedLinear",
                                                   "QuantedLinear"]
    assert [type(m).__name__ for m in model] == ["Plain", "Plain", "Linear"]
    assert swapped[1](torch.ones(2, 4)).shape == (2, 3)


def test_double_quantize_does_not_double_wrap():
    def net(m):
        return m.nn.Sequential(m.nn.Conv2D(3, 4, 3), m.nn.Linear(4, 4))

    jm, tm = _pair(net)
    for q, model in ((Q, tm), (JQ, jm)):
        qat = q.QAT(q.QuantConfig(weight=q.FakeQuanterChannelWiseAbsMax()))
        kinds = _kinds(qat.quantize(qat.quantize(model)))
        assert kinds.count("QuantedConv2D") == 1
        assert kinds.count("QuantedLinear") == 1
        assert kinds.count("Conv2D") == 0


def test_quantize_not_inplace_preserves_original():
    jm, tm = _pair(lambda m: m.nn.Sequential(m.nn.Linear(4, 4)))
    for q, model in ((Q, tm), (JQ, jm)):
        cfg = q.QuantConfig(weight=q.FakeQuanterChannelWiseAbsMax())
        qmodel = q.QAT(cfg).quantize(model, inplace=False)
        assert "QuantedLinear" not in _kinds(model)
        assert "QuantedLinear" in _kinds(qmodel)
    cfg = Q.QuantConfig(weight=Q.FakeQuanterChannelWiseAbsMax())
    inplace = Q.QAT(cfg).quantize(tm, inplace=True)
    assert inplace is tm and "QuantedLinear" in _kinds(tm)


def test_llama_tiny_swap_set_is_the_references():
    """Trouble spot 2: the port's Llama projections are private
    subclasses of ``nn.Linear`` and its model a ``torch.nn.Module``; QAT
    swaps exactly what it swaps on the reference's model: every
    projection and the head, 7 x layers + 1."""
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    jt.seed(0)
    want = _quanted(JQ.QAT(_cfg(JQ)).quantize(JaxLlama(jax_llama_tiny())))
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    got = [n for n, m in Q.QAT(_cfg(Q)).quantize(tm).named_modules()
           if isinstance(m, Q.QuantedLinear)]
    assert got == want and len(got) == 7 * 2 + 1


# ------------------------------------------------------- quantized layers

def test_qat_output_is_quantized():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    jl, tl = _pair(lambda m: m.nn.Linear(8, 8))
    ref = tl(torch.tensor(x)).detach().numpy()
    tq = Q.QuantedLinear(tl, _cfg(Q, act=False)._default)
    jq = JQ.QuantedLinear(jl, _cfg(JQ, act=False)._default)
    out = tq(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(out, _np(jq(jt.to_tensor(x))), rtol=TOL,
                               atol=TOL)
    assert not np.allclose(out, ref)
    assert np.abs(out - ref).max() < 0.1   # the 8-bit error bound


def test_quanted_conv2d_matches_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 2, 6, 6)).astype(np.float32)
    jc, tc = _pair(lambda m: m.nn.Conv2D(2, 3, 3, padding=1))
    ref = tc(torch.tensor(x)).detach().numpy()
    tq = Q.QuantedConv2D(tc, Q.QuantConfig(
        weight=Q.FakeQuanterChannelWiseAbsMax(quant_axis=0))._default)
    jq = JQ.QuantedConv2D(jc, JQ.QuantConfig(
        weight=JQ.FakeQuanterChannelWiseAbsMax(quant_axis=0))._default)
    out = tq(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(out, _np(jq(jt.to_tensor(x))), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(out - ref).max() < 0.15


def test_channelwise_axis_inferred_per_layer_kind():
    jc, tc = _pair(lambda m: m.nn.Conv2D(2, 3, 3))
    jl, tl = _pair(lambda m: m.nn.Linear(5, 7))
    tcq = Q.QuantedConv2D(tc, _cfg(Q, act=False)._default)
    tlq = Q.QuantedLinear(tl, _cfg(Q, act=False)._default)
    jcq = JQ.QuantedConv2D(jc, _cfg(JQ, act=False)._default)
    assert tcq.weight_quanter.quant_axis() == 0   # conv OIHW out-channel
    assert tlq.weight_quanter.quant_axis() == 1   # linear [in, out] out
    x = np.ones((1, 2, 5, 5), np.float32)
    tcq(pt.to_tensor(x))
    jcq(jt.to_tensor(x))
    assert tcq.weight_quanter.scales().shape == [3, 1, 1, 1]
    np.testing.assert_array_equal(_np(tcq.weight_quanter.scales()),
                                  _np(jcq.weight_quanter.scales()))


def test_transpose_conv_quant_axis():
    for m, q in ((pt, Q), (jt, JQ)):
        convT = m.nn.Conv2DTranspose(4, 6, 3)
        cfg = q.QuantConfig(weight=q.FakeQuanterChannelWiseAbsMax())
        assert cfg._default.weight._instance(convT).quant_axis() == 1


def test_nn_quant_exports_stub_and_the_quantized_layers():
    from paddle_tpu_torch.nn import quant
    assert quant.QuantedLinear is Q.QuantedLinear
    assert quant.QuantedConv2D is Q.QuantedConv2D
    stub = quant.Stub()
    x = torch.ones(2, 3)
    assert stub(x) is x and isinstance(stub, pt.nn.Layer)


# -------------------------------------------------------------- observers

RNG = np.random.RandomState(0)
GAUSS = [RNG.randn(512).astype(np.float32) for _ in range(8)]


def _feed(q, name, batches, **kw):
    obs = getattr(q, name)._layer_cls(None, **kw)
    for b in batches:
        obs(_tensor(q, b))
    return obs


OBSERVER_CASES = {
    "absmax": ("AbsmaxObserver", [np.array([1.0, -3.0], np.float32),
                                  np.array([2.0], np.float32)], {}, 3.0),
    "ema": ("EMAObserver", [np.array([4.0], np.float32),
                            np.array([2.0], np.float32)],
            {"moving_rate": 0.5}, 3.0),
    "avg": ("AVGObserver", [np.array([4.0], np.float32),
                            np.array([2.0], np.float32)], {}, 3.0),
    "hist_outlier": ("HistObserver",
                     GAUSS + [np.array([100.0], np.float32)], {}, None),
    "kl": ("KLObserver", GAUSS, {}, None),
    "mse_outlier": ("MSEObserver",
                    GAUSS + [np.array([30.0], np.float32)], {}, None),
}


@pytest.mark.parametrize("case", sorted(OBSERVER_CASES))
def test_observer_scales_equal_the_reference(case):
    name, batches, kw, exact = OBSERVER_CASES[case]
    got = _feed(Q, name, batches, **kw)
    want = _feed(JQ, name, batches, **kw)
    got.cal_thresholds()
    want.cal_thresholds()
    s = _np(got.scales())
    np.testing.assert_array_equal(s, _np(want.scales()))
    assert got.scales().dtype == pt.float32
    if exact is not None:
        assert abs(float(s) - exact) < 1e-6
    if case == "hist_outlier":
        assert 1.0 < float(s) < 50.0      # the percentile clips the outlier
    if case == "kl":
        mx = max(float(np.abs(g).max()) for g in GAUSS)
        assert 0.5 < float(s) <= mx + 1e-6
    if case == "mse_outlier":
        assert float(s) < 30.0


def test_hist_scale_invalidated_by_new_data():
    for q in (Q, JQ):
        obs = _feed(q, "HistObserver", [np.ones(64, np.float32)])
        s1 = float(_np(obs.scales()))
        obs(_tensor(q, np.full(512, 50.0, np.float32)))
        assert float(_np(obs.scales())) > s1 * 5


def test_hist_observer_reads_bf16():
    x = torch.tensor(GAUSS[0]).bfloat16()
    obs = Q.HistObserver._layer_cls(None)
    obs(x)
    want = _feed(JQ, "HistObserver", [x.float().numpy()])
    np.testing.assert_array_equal(_np(obs.scales()), _np(want.scales()))


def test_ptq_observer_calibration():
    rng = np.random.RandomState(0)
    jm, tm = _pair(lambda m: m.nn.Sequential(m.nn.Linear(4, 4)))
    scales = []
    for q, m, model in ((Q, pt, tm), (JQ, jt, jm)):
        pmodel = q.PTQ(q.QuantConfig(activation=q.AbsmaxObserver())
                       ).quantize(model)
        for i in range(3):
            rs = np.random.RandomState(i)
            pmodel(m.to_tensor(rs.randn(8, 4).astype(np.float32) * 3))
        (name,) = _quanted(pmodel)
        quanted = dict(pmodel.named_sublayers())[name]
        scales.append(float(_np(quanted.activation_quanter.scales())))
    assert scales[0] == scales[1] > 2.0
    del rng


def test_convert_freezes_observer():
    rng = np.random.RandomState(0)
    x1 = rng.randn(8, 4).astype(np.float32)
    x2 = rng.randn(8, 4).astype(np.float32) * 100
    jm, tm = _pair(lambda m: m.nn.Sequential(m.nn.Linear(4, 4)))
    for q, m, model in ((Q, pt, tm), (JQ, jt, jm)):
        cfg = q.QuantConfig(activation=q.AbsmaxObserver())
        model = q.PTQ(cfg).quantize(model)
        model(m.to_tensor(x1))
        frozen = q.PTQ(cfg).convert(model)
        (name,) = _quanted(frozen)
        quanted = dict(frozen.named_sublayers())[name]
        before = float(_np(quanted.activation_quanter.scales()))
        frozen(m.to_tensor(x2))
        assert float(_np(quanted.activation_quanter.scales())) == before
        assert not frozen.training
        live = dict(model.named_sublayers())[name]
        assert live.activation_quanter._frozen is False


def test_observer_in_ptq_flow():
    rng = np.random.RandomState(3)
    xs = [rng.randn(4, 8).astype(np.float32) for _ in range(5)]
    jm, tm = _pair(lambda m: m.nn.Sequential(m.nn.Linear(8, 8)))
    outs = []
    for q, m, model in ((Q, pt, tm), (JQ, jt, jm)):
        cfg = q.QuantConfig(activation=q.HistObserver(),
                            weight=q.AbsmaxObserver())
        ptq = q.PTQ(cfg)
        qmodel = ptq.quantize(model)
        for x in xs[:4]:
            qmodel(m.to_tensor(x))
        outs.append(_np(ptq.convert(qmodel)(m.to_tensor(xs[4]))))
    assert np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], outs[1], rtol=TOL, atol=TOL)


# ------------------------------------------------------------- int8 deploy

def test_int8_inference_of_a_quanted_linear():
    """The reference's ``to_int8_inference`` takes a ``QuantedLinear``
    (``qat.py:189-202``): int8 codes and scales of its float weight equal
    the reference's; outputs within one quantisation step."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    jl, tl = _pair(lambda m: m.nn.Sequential(m.nn.Linear(64, 32)))
    res = []
    for q, m, model in ((Q, pt, tl), (JQ, jt, jl)):
        qat = q.QAT(_cfg(q))
        qmodel = qat.quantize(model)
        qmodel(m.to_tensor(x))
        i8 = q.to_int8_inference(qat.convert(qmodel))
        (layer,) = [s for _, s in i8.named_sublayers()
                    if type(s).__name__ == "Int8InferLinear"]
        res.append((_np(layer.qweight), _np(layer.w_scale),
                    _np(i8(m.to_tensor(x)))))
        assert _quanted(qmodel) == ["0"]
    (qw, sw, out), (jqw, jsw, jout) = res
    np.testing.assert_array_equal(qw, jqw)
    np.testing.assert_array_equal(sw, jsw)
    step = float(np.abs(x).max() / 127 * sw.max() * 127)
    assert np.abs(out - jout).max() <= step


# ---------------------------------------------------------------- training

def test_qat_model_trains():
    rng = np.random.RandomState(0)
    x = rng.randn(32, 8).astype(np.float32)
    y = rng.randint(0, 2, size=(32,)).astype(np.int32)
    jm, tm = _pair(lambda m: m.nn.Sequential(m.nn.Linear(8, 16),
                                             m.nn.ReLU(),
                                             m.nn.Linear(16, 2)))
    runs = []
    for q, m, model in ((Q, pt, tm), (JQ, jt, jm)):
        qmodel = q.QAT(_cfg(q)).quantize(model)
        qmodel.train()
        opt = m.optimizer.AdamW(learning_rate=5e-2,
                                parameters=qmodel.parameters())
        losses = []
        for _ in range(25):
            loss = m.nn.functional.cross_entropy(qmodel(m.to_tensor(x)),
                                                 m.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(_np(loss)))
        runs.append(losses)
    got, want = runs
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=TOL_STEP)
    for losses in runs:
        assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_three_qat_steps_of_llama_tiny_match_the_reference():
    """``llama_tiny`` under QAT (moving abs-max activations, channel-wise
    weights), three AdamW steps on one batch: the losses and the
    activation scales of every swapped layer against the reference's."""
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                         load_jax_params)
    jt.seed(5)
    jm = JaxLlama(jax_llama_tiny())
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    ids = np.random.default_rng(5).integers(0, 256, (2, 16)).astype(
        np.int32)
    runs = []
    for q, m, model, tid in ((Q, pt, tm, torch.from_numpy(ids).long()),
                             (JQ, jt, jm, jt.to_tensor(ids))):
        qmodel = q.QAT(_cfg(q)).quantize(model)
        qmodel.train()
        opt = m.optimizer.AdamW(learning_rate=1e-3,
                                parameters=qmodel.parameters())
        losses = []
        for _ in range(3):
            loss = qmodel.loss(qmodel(tid), tid)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(_np(loss)))
        subs = qmodel.named_modules() if q is Q else \
            qmodel.named_sublayers()
        scales = {n: float(_np(s.scales())) for n, s in subs
                  if type(s).__name__ == "FakeQuanterWithAbsMaxObserverLayer"}
        runs.append((losses, scales))
    (got, gs), (want, ws) = runs
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_STEP)
    assert got[-1] < got[0]
    assert gs.keys() == ws.keys() and len(gs) == 15
    for n in gs:
        assert abs(gs[n] - ws[n]) <= TOL_STEP * max(1.0, ws[n]), n

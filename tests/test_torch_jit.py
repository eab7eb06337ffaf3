"""``paddle_tpu_torch.jit`` against ``paddle_tpu.jit``, on the CPU.

``llama_tiny`` is built on the JAX side from a seed and bridged into the
port (``load_jax_params``); the same numpy ids go through both, f32.

- ``functional_call`` with the model's own and with other parameter
  values, ``to_static`` (a ``TranslatedLayer``) and ``grad_and_loss``:
  logits and losses within 1e-5 of the reference's, gradients name for
  name within atol 1e-5 / rtol 1e-4 (``test_torch_llama_training.py``'s
  tolerance: two layers of products summed in another order), greedy
  tokens equal; ``to_static`` equals the eager forward bit for bit, a
  fresh key each call;
- ``save`` / ``load`` of ``llama_tiny`` with a dynamic batch: the archive
  equals the eager port bit for bit at batch 2 and 3 and is within 1e-5
  of the reference's archive, tokens equal; without an ``input_spec``
  ``load`` gives the state dict;
- the reference's ``test_jit_save_export_layer``,
  ``test_jit_save_dynamic_batch`` and
  ``test_export_restores_sublayer_training``;
- ``functional_call`` given only some parameters, as the reference's;
- the switches: ``enable_to_static(False)`` runs the original,
  ``not_to_static`` marks, ``ignore_module`` leaves a module's functions
  as they are.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.static import InputSpec as JaxInputSpec
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny, \
    load_jax_params
from paddle_tpu_torch.static import InputSpec

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
T = 8


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    place = tdevice._default[0]
    before = torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=1)
def _models():
    jt.seed(24)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _ids(B, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (B, T)).astype(
        np.int32)


def _logits(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _host(x):
    if isinstance(x, (pt.Tensor, jt.Tensor)):
        x = x.numpy()
    if torch.is_tensor(x):
        x = x.detach().numpy()
    return np.asarray(x, np.float64)


def test_functional_call_matches_the_reference():
    jm, tm = _models()
    ids = _ids(2)
    jp = jm.raw_params()
    want = _logits(jt.jit.functional_call(jm, jp, jnp.asarray(ids)))
    got = _logits(pt.jit.functional_call(tm, dict(tm.named_parameters()),
                                         torch.as_tensor(ids)))
    np.testing.assert_allclose(_host(got), _host(want), **TOL)
    # other values: every parameter scaled, the model's own untouched
    scaled = {n: v * 0.5 for n, v in tm.named_parameters()}
    jscaled = {n: v * 0.5 for n, v in jp.items()}
    got = _logits(pt.jit.functional_call(tm, scaled, torch.as_tensor(ids)))
    want = _logits(jt.jit.functional_call(jm, jscaled, jnp.asarray(ids)))
    np.testing.assert_allclose(_host(got), _host(want), **TOL)
    with torch.no_grad():
        eager = _logits(tm(torch.as_tensor(ids)))
    assert not torch.equal(got, eager)


def test_to_static_equals_eager_and_the_reference():
    jm, tm = _models()
    ids = _ids(3, seed=1)
    ts = pt.jit.to_static(tm)
    assert isinstance(ts, pt.jit.TranslatedLayer) and ts.layer is tm
    k0 = pt.get_rng_state()[1]
    got = _logits(ts(torch.as_tensor(ids)))
    assert pt.get_rng_state()[1] == k0 + 1         # a fresh key a call
    assert isinstance(got, pt.Tensor) and got.stop_gradient
    with torch.no_grad():
        eager = _logits(tm(torch.as_tensor(ids)))
    assert torch.equal(got.value, eager)
    want = _logits(jt.jit.to_static(jm)(jnp.asarray(ids)))
    np.testing.assert_allclose(_host(got), _host(want), **TOL)
    np.testing.assert_array_equal(_host(got).argmax(-1),
                                  _host(want).argmax(-1))


def test_grad_and_loss_matches_the_reference():
    jm, tm = _models()
    ids = _ids(2, seed=2)

    def loss_fn(out):
        lg = _logits(out)
        return (lg * lg).mean()

    jloss, jgrads = jt.jit.grad_and_loss(jm, loss_fn)(
        jm.raw_params(), (jnp.asarray(ids),))
    params = {n: p for n, p in tm.named_parameters()}
    loss, grads = pt.jit.grad_and_loss(tm, loss_fn)(
        params, (torch.as_tensor(ids),))
    np.testing.assert_allclose(_host(loss), _host(jloss), **TOL)
    assert set(grads) == set(jgrads)
    for n in grads:
        np.testing.assert_allclose(_host(grads[n]), _host(jgrads[n]),
                                   err_msg=n, **GRAD_TOL)
    # eager autograd gives the same numbers
    tm.zero_grad()
    eager = loss_fn(tm(torch.as_tensor(ids)))
    eager.backward()
    assert torch.equal(eager.detach(), loss)
    for n, p in tm.named_parameters():
        assert torch.equal(p.grad, grads[n]), n
    tm.zero_grad()


def test_save_load_llama_dynamic_batch(tmp_path):
    jm, tm = _models()
    prefix = str(tmp_path / "port" / "llama")
    pt.jit.save(tm, prefix, input_spec=[InputSpec([-1, T], "int32")])
    jprefix = str(tmp_path / "jax" / "llama")
    jt.jit.save(jm, jprefix, input_spec=[JaxInputSpec([-1, T], "int32")])
    loaded = pt.jit.load(prefix, device="cpu")
    jloaded = jt.jit.load(jprefix)
    for B in (2, 3):
        ids = _ids(B, seed=B)
        got = _logits(loaded(ids))
        with torch.no_grad():
            eager = _logits(tm(torch.as_tensor(ids)))
        assert torch.equal(got, eager)
        want = _logits(jloaded(ids))
        np.testing.assert_allclose(_host(got), _host(want), **TOL)
        np.testing.assert_array_equal(_host(got).argmax(-1),
                                      _host(want).argmax(-1))
    # without an input_spec: the state dict alone
    plain = str(tmp_path / "plain")
    pt.jit.save(tm, plain)
    state = pt.jit.load(plain)
    assert set(state) == set(tm.state_dict())


def _seq(m, port):
    m.seed(3)
    layer = m.nn.Sequential(m.nn.Linear(8, 16), m.nn.ReLU(),
                            m.nn.Linear(16, 4))
    return layer.to("cpu") if port else layer


def test_jit_save_export_layer(tmp_path):
    xv = np.random.default_rng(4).random((2, 8)).astype("float32")
    outs = []
    for m, spec, port in ((jt, JaxInputSpec, False), (pt, InputSpec, True)):
        layer = _seq(m, port)
        ref = np.asarray(layer(m.to_tensor(xv)).numpy())
        prefix = str(tmp_path / m.__name__ / "seq")
        m.jit.save(layer, prefix,
                   input_spec=[spec([2, 8], "float32", "x")])
        loaded = m.jit.load(prefix, **({"device": "cpu"} if port else {}))
        out = _logits(loaded(xv))
        np.testing.assert_allclose(_host(out), ref, rtol=1e-5)
        outs.append(_host(out))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_jit_save_dynamic_batch(tmp_path):
    """A -1 batch dim exports symbolically: one archive serves any batch
    size."""
    layers = {}
    for m, spec, port in ((jt, JaxInputSpec, False), (pt, InputSpec, True)):
        m.seed(5)
        layer = m.nn.Linear(8, 3)
        layer = layer.to("cpu") if port else layer
        prefix = str(tmp_path / m.__name__ / "dyn")
        m.jit.save(layer, prefix,
                   input_spec=[spec([-1, 8], "float32", "x")])
        layers[port] = (layer, m.jit.load(
            prefix, **({"device": "cpu"} if port else {})), m)
    for bs in (1, 4, 7):
        xv = np.random.default_rng(bs).random((bs, 8)).astype("float32")
        outs = []
        for port in (False, True):
            layer, loaded, m = layers[port]
            out = _host(_logits(loaded(xv)))
            ref = np.asarray(layer(m.to_tensor(xv)).numpy())
            np.testing.assert_allclose(out, ref, rtol=1e-5)
            outs.append(out)
        np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_export_restores_sublayer_training(tmp_path):
    for m, spec, port in ((jt, JaxInputSpec, False), (pt, InputSpec, True)):
        layer = m.nn.Sequential(m.nn.Linear(4, 4), m.nn.Dropout(0.5))
        layer = layer.to("cpu") if port else layer
        layer.train()
        m.jit.save(layer, str(tmp_path / m.__name__ / "m"),
                   input_spec=[spec([2, 4], "float32", "x")])
        assert layer.training
        assert all(s.training for _, s in layer.named_sublayers())


def test_the_switches():
    calls = []

    def f(x):
        calls.append(1)
        if x.sum() > 0:
            y = x + 1
        else:
            y = x - 1
        return y

    g = pt.jit.to_static(f)
    x = pt.to_tensor([1.0])
    pt.jit.enable_to_static(False)
    try:
        np.testing.assert_allclose(g(x).numpy(), [2.0])
    finally:
        pt.jit.enable_to_static(True)
    np.testing.assert_allclose(g(x).numpy(), [2.0])
    assert len(calls) == 2
    assert pt.jit.not_to_static(f)._not_to_static
    from paddle_tpu_torch.jit import dy2static
    pt.jit.ignore_module([__name__])
    try:
        assert dy2static.convert_to_static(_helper) is _helper
    finally:
        pt.jit._ignored_modules.remove(__name__)
    assert dy2static.convert_to_static(_helper) is not _helper
    pt.jit.set_verbosity(1)
    pt.jit.set_code_level(2)
    pt.jit.set_verbosity(0)
    pt.jit.set_code_level(100)


def _helper(x):
    if x.sum() > 0:
        x = x + 1
    return x


def test_functional_call_with_some_parameters_given():
    """A parameter left out of ``params`` keeps its own value, as in the
    reference's (which substitutes only the names it is given); the
    model's own parameters are untouched after the call."""
    jm, tm = _models()
    ids = _ids(2, seed=1)
    jp = jm.raw_params()
    name = sorted(n for n in jp if "norm" in n)[-1]
    own = {n: v.detach().clone() for n, v in tm.named_parameters()}
    got = _logits(pt.jit.functional_call(
        tm, {name: dict(tm.named_parameters())[name] * 3.0},
        torch.as_tensor(ids)))
    want = _logits(jt.jit.functional_call(
        jm, {name: jp[name] * 3.0}, jnp.asarray(ids)))
    np.testing.assert_allclose(_host(got), _host(want), **TOL)
    for n, v in tm.named_parameters():
        assert torch.equal(v, own[n]), n
    with torch.no_grad():
        eager = _logits(tm(torch.as_tensor(ids)))
    assert not torch.equal(got, eager)

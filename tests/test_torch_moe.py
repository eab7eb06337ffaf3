"""The port's ``parallel.moe`` against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages; the reference's
weights are copied into the port with ``set_state_dict``. Tolerances,
f32:

- the gates (naive, gshard, switch; flat ``[T, D]`` and grouped ``[G, g,
  D]``): the dispatch masks EQUAL (the routing is discrete: softmax in
  f32, the first maximum, positions by a cumsum in token order), the
  combine weights within 1e-6, the aux loss within 1e-6; a capacity
  factor tight enough to drop tokens drops the same ones; SwitchGate's
  jitter is R2's uniform draw from the global key, bit for bit the
  reference's, one key a call, shared by the groups;
- ``MoELayer`` (ExpertMLP with tanh gelu, ExpertSwiGLU, a LayerList of
  Linear experts; flat and grouped dispatch): the output within 1e-5, the
  aux loss within 1e-6, every gradient within 1e-4 of its largest;
  ``group_size`` not dividing the tokens warns as the reference does;
- ``ClipGradForMOEByGlobalNorm`` with and without the parameters within
  1e-6; the port's fused AdamW takes it as the plain global-norm clip,
  bit for bit ``ClipGradByGlobalNorm``'s step (the reference's fused step
  calls ``clip_values(grads)`` without the parameters).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jt
from paddle_tpu.parallel import moe as jmoe
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import random as trnd
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import threefry_fill
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import moe as tmoe

@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    """The CPU place (the default is the card) and one torch thread a
    worker; both restored after the module."""
    place, threads = tdevice._default[0], torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    tdevice._default[0] = place
    torch.set_num_threads(threads)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(make):
    """(reference layer, port layer) with the reference's weights."""
    jt.seed(11)
    ref = make(jmoe)
    port = make(tmoe)
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    return ref, port


def _gate_outputs(ref, port, x):
    jo = ref(jt.to_tensor(x))
    to = port(torch.from_numpy(x))
    return jo, to


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


GATES = {"naive": lambda m: m.NaiveGate(16, 4),
         "gshard": lambda m: m.GShardGate(16, 4, capacity_factor=1.0),
         "switch": lambda m: m.SwitchGate(16, 4, capacity_factor=1.0,
                                          jitter=0.0)}


@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
@pytest.mark.parametrize("kind", sorted(GATES))
def test_gate_dispatch_matches_jax(kind, grouped):
    ref, port = _pair(GATES[kind])
    x = _x(3, 16, 16) if grouped else _x(24, 16)
    jo, to = _gate_outputs(ref, port, x)
    assert np.array_equal(_np(to.dispatch_mask), _np(jo.dispatch_mask))
    np.testing.assert_allclose(_np(to.combine), _np(jo.combine),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(_np(to.aux_loss)), float(_np(jo.aux_loss)),
                               rtol=0, atol=1e-6)
    assert to.combine.shape == tuple(_np(jo.combine).shape)


@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
def test_tight_capacity_drops_the_references_tokens(grouped):
    """capacity_factor 0.5 on 32 tokens of 4 experts: capacity 8 a group
    of two choices each, so tokens are dropped, the same ones."""
    ref, port = _pair(lambda m: m.GShardGate(16, 4, capacity_factor=0.5))
    x = _x(2, 32, 16, seed=3) if grouped else _x(32, 16, seed=3)
    jo, to = _gate_outputs(ref, port, x)
    kept = _np(to.dispatch_mask).any(axis=(-1, -2)).sum()
    assert kept < x.shape[-2] * (2 if grouped else 1), "nothing dropped"
    assert np.array_equal(_np(to.dispatch_mask), _np(jo.dispatch_mask))
    np.testing.assert_allclose(_np(to.combine), _np(jo.combine),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
def test_switch_jitter_is_the_references_draw_bit_for_bit(grouped):
    """SwitchGate(jitter=0.1) in training: one key from the global state a
    call (both counters advance by one), the noise R2's uniform in [0.9,
    1.1] bit for bit ``jax.random.uniform``'s, shared by every group; the
    port's gate output is its own dispatch of ``logits * noise``
    exactly."""
    ref, port = _pair(lambda m: m.SwitchGate(16, 4, capacity_factor=2.0,
                                             jitter=0.1))
    x = _x(3, 8, 16, seed=5) if grouped else _x(24, 16, seed=5)
    jt.seed(9)
    pt.seed(9)
    jo, to = _gate_outputs(ref, port, x)
    assert jt.get_rng_state()[1] == pt.get_rng_state()[1] == 1
    pt.seed(9)
    key = trnd.next_key()
    noise = threefry_fill.uniform(key, (x.shape[-2], 4), "cpu", 0.9, 1.1)
    jt.seed(9)
    from paddle_tpu.core import random as jrnd
    want = jax.random.uniform(jrnd.next_key(), (x.shape[-2], 4),
                              jnp.float32, 0.9, 1.1)
    assert np.array_equal(noise.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))
    logits = torch.from_numpy(x) @ port.gate.weight.detach()
    combine, mask, _ = tmoe.gate._top1_dense_dispatch(
        logits * noise, port.capacity(x.shape[-2]))
    assert torch.equal(to.combine, combine)
    assert np.array_equal(_np(to.dispatch_mask), _np(jo.dispatch_mask))
    np.testing.assert_allclose(_np(to.combine), _np(jo.combine),
                               rtol=0, atol=1e-6)


LAYERS = {
    "mlp": lambda m: m.MoELayer(16, num_experts=4, d_hidden=32,
                                gate="gshard", capacity_factor=2.0),
    "swiglu": lambda m: m.MoELayer(16, experts=m.ExpertSwiGLU(4, 16, 32),
                                   gate="gshard", capacity_factor=1.0),
    "switch": lambda m: m.MoELayer(16, num_experts=4, d_hidden=32,
                                   gate="switch", capacity_factor=2.0),
}


def _layer_list(m):
    nn = jt.nn if m is jmoe else pt.nn
    return m.MoELayer(16, experts=[nn.Linear(16, 16) for _ in range(4)],
                      gate="naive", capacity_factor=1.5)


LAYERS["list"] = _layer_list


def _run_layer(pkg, layer, x, r):
    xt = pkg.to_tensor(x, stop_gradient=False)
    out = layer(xt)
    aux = layer.aux_loss
    loss = (out * pkg.to_tensor(r)).sum() + aux * 0.1
    loss.backward()
    grads = {n: _np(p.grad) for n, p in layer.named_parameters()}
    return _np(out), float(_np(aux)), _np(xt.grad), grads


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("group", [None, 8], ids=["flat", "grouped"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_moe_layer_matches_jax(kind, group):
    ref, port = _pair(LAYERS[kind])
    ref.group_size = port.group_size = group
    if kind == "switch":                 # no jitter: the draw has its test
        ref.gate.jitter = port.gate.jitter = 0.0
    x, r = _x(4, 8, 16, seed=1), _x(4, 8, 16, seed=2)
    jo, ja, jgx, jg = _run_layer(jt, ref, x, r)
    to, ta, tgx, tg = _run_layer(pt, port, x, r)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
    assert abs(ta - ja) <= 1e-6
    assert set(tg) == set(jg)
    for n in jg:
        assert _rel(tg[n], jg[n]) <= 1e-4, n
    assert _rel(tgx, jgx) <= 1e-4


def test_group_that_does_not_divide_warns_as_the_reference():
    ref, port = _pair(LAYERS["mlp"])
    ref.group_size = port.group_size = 12
    x = _x(2, 10, 16, seed=4)             # 20 tokens, groups of 12
    with pytest.warns(UserWarning, match="does not divide 20 tokens"):
        jo = _np(ref(jt.to_tensor(x)))
    with pytest.warns(UserWarning, match="does not divide 20 tokens"):
        to = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)


def test_expert_parallel_groups_raise_naming_item_13():
    for kw in ({"moe_group": object()}, {"mp_group": object()}):
        with pytest.raises(NotImplementedError, match="item 13"):
            tmoe.MoELayer(16, num_experts=4, d_hidden=32, **kw)


def test_experts_draw_the_references_weights():
    """ExpertSwiGLU and ExpertMLP draw Xavier-normal from the global key
    as the reference does (R2's normal, within 3 ulps)."""
    for make in (lambda m: m.ExpertSwiGLU(4, 16, 32),
                 lambda m: m.ExpertMLP(4, 16, 32)):
        jt.seed(5)
        ref = make(jmoe)
        pt.seed(5)
        port = make(tmoe)
        for (n, p), (_, q) in zip(ref.named_parameters(),
                                  port.named_parameters()):
            np.testing.assert_allclose(q.detach().numpy(), _np(p),
                                       rtol=1e-6, atol=1e-7, err_msg=n)


def _grads(seed, n=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((7, 3)).astype(np.float32) * (i + 1)
            for i in range(n)]


@pytest.mark.parametrize("with_params", [False, True])
def test_clip_for_moe_matches_jax(with_params):
    gs = _grads(0)
    expert = [False, True, False, True, True]

    def params(pkg):
        # the clip reads only the default ``is_expert`` attribute of each
        return [types.SimpleNamespace(is_expert=e) for e in expert]

    jc = jmoe.ClipGradForMOEByGlobalNorm(2.0)
    tc = tmoe.ClipGradForMOEByGlobalNorm(2.0)
    jargs = [jnp.asarray(g) for g in gs]
    targs = [torch.tensor(g) for g in gs]
    if with_params:
        want = jc.clip_values(jargs, params(jt))
        got = tc.clip_values(targs, params(pt))
    else:
        want = jc.clip_values(jargs)
        got = tc.clip_values(targs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    assert float(np.sqrt(sum((np.asarray(b) ** 2).sum() for b in want))) \
        == pytest.approx(2.0, rel=1e-5)


def test_fused_adamw_takes_the_moe_clip_as_the_global_norm_clip():
    """The optimizer's fused step with ClipGradForMOEByGlobalNorm is bit
    for bit its step with ClipGradByGlobalNorm: the plain global norm, as
    the reference's fused step calls ``clip_values(grads)``."""
    out = []
    for clip in (tmoe.ClipGradForMOEByGlobalNorm(0.5),
                 ClipGradByGlobalNorm(0.5)):
        ps = [torch.nn.Parameter(torch.tensor(g)) for g in _grads(1)]
        opt = AdamW(learning_rate=0.1, parameters=ps, grad_clip=clip)
        for p, g in zip(ps, _grads(2)):
            p.grad = torch.tensor(g)
        opt.step()
        out.append([p.detach().clone() for p in ps])
    assert all(torch.equal(a, b) for a, b in zip(*out))

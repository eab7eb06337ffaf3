"""The port's incubate layers, ``fused_ec_moe``, ``LookAhead`` /
``ModelAverage``, ``incubate.autograd`` (``forward_grad``), the
auto-checkpoint, ``regularizer`` and ``callbacks``, against the JAX
package's on the CPU: the incubate cases of ``tests/test_parity_tail.py``,
``TrainEpochRange`` of ``tests/test_debug_aux.py`` and ``forward_grad`` of
``tests/test_stub_completions.py``, each through both packages on the
same numpy inputs made from a seed, the reference's weights carried
across:

- values and gradients within ``TOL`` (f32; ``TOL_MOE`` for
  ``fused_ec_moe``, whose scatter-add sums a token's experts in another
  order); dropouts under one ``seed()`` draw the reference's masks;
- ``fused_ec_moe`` takes the lower token first among equal scores, as
  ``jax.lax.top_k``;
- ``LookAhead`` against its update written out (the reference's never
  runs: ROADMAP, Queue 3);
- the graph aliases of item 15.7 raise, naming it.
"""
import copy
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice
from test_torch_incubate import _both, _close, _pair

TOL = 1e-5
TOL_MOE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def test_lookahead_pulls_slow_weights():
    """Four SGD steps under ``LookAhead(alpha=0.5, k=2)`` against the
    same SGD steps with the slow-weight update written out. (The
    reference's ``LookAhead`` reads ``_parameter_list``, which its
    optimizers do not have, so there the update never runs: ROADMAP,
    Queue 3.)"""
    x = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    tl = pt.nn.Linear(4, 4)
    oracle = copy.deepcopy(tl)
    w0 = tl.weight.numpy().copy()
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=tl.parameters())
    la = pt.incubate.LookAhead(opt, alpha=0.5, k=2)
    plain = pt.optimizer.SGD(learning_rate=0.1,
                             parameters=oracle.parameters())
    slow = [p.detach().clone() for p in oracle.parameters()]
    for i in range(4):
        for lin, step, clear in ((tl, la.step, la.clear_grad),
                                 (oracle, plain.step, plain.clear_grad)):
            loss = (lin(pt.to_tensor(x)) ** 2).mean()
            loss.backward()
            step()
            clear()
        if (i + 1) % 2 == 0:
            with torch.no_grad():
                for s_, p in zip(slow, oracle.parameters()):
                    s_.add_(0.5 * (p - s_))
                    p.copy_(s_)
    assert la.state_dict()["lookahead_step"] == 4
    assert not np.allclose(tl.weight.numpy(), w0)
    np.testing.assert_array_equal(tl.weight.numpy(), oracle.weight.numpy())
    np.testing.assert_array_equal(tl.bias.numpy(), oracle.bias.numpy())
    la.set_state_dict(la.state_dict())
    assert la._step_count == 4 and la.get_lr() == 0.1


def test_model_average_apply_restore():
    import jax.numpy as jnp
    jl, tl = _pair(lambda m: m.nn.Linear(3, 3))
    ma = pt.incubate.ModelAverage(parameters=tl.parameters())
    ma.step()
    cur = tl.weight.numpy().copy()
    tl.weight.set_value(np.ones((3, 3), np.float32))
    ma.step()
    with torch.no_grad():
        tl.weight.zero_()
    with ma.apply():
        _close(tl.weight, (cur + 1.0) / 2)
    _close(tl.weight, np.zeros((3, 3)))
    jma = jt.incubate.ModelAverage(parameters=jl.parameters())
    jma.step()
    jl.weight._replace_value(jnp.ones((3, 3), jnp.float32))
    jma.step()
    jl.weight._replace_value(jnp.zeros((3, 3), jnp.float32))
    with jma.apply():
        _close(jl.weight, (cur + 1.0) / 2)


def test_fused_ec_moe_routes_and_trains():
    def moe(m):
        m.seed(0)
        return m.incubate.nn.FusedEcMoe(16, 32, 4)

    jm, tm = _pair(moe)
    rng = np.random.default_rng(11)
    z = rng.standard_normal((2, 8, 16)).astype(np.float32)
    logits = rng.standard_normal((2, 8, 4)).astype(np.float32)
    res = []
    for m, layer in ((pt, tm), (jt, jm)):
        x = m.to_tensor(z, stop_gradient=False)
        out = layer(x)
        out.sum().backward()
        assert np.isfinite(layer.w1.grad.numpy()).all()
        out2 = layer(x, gate_logits=m.to_tensor(logits))
        assert not np.allclose(out.numpy(), out2.numpy())
        res.append((out, out2, x.grad, layer.w1.grad, layer.gate.grad))
    for g, w in zip(*res):
        _close(g, w, TOL_MOE)


def test_fused_ec_moe_takes_the_lower_token_among_ties():
    """Equal gate logits: every score ties, and each expert takes the
    first ``T // E`` tokens (``jax.lax.top_k``'s order)."""
    rng = np.random.default_rng(12)
    a = {"x": rng.standard_normal((1, 8, 4)).astype(np.float32),
         "g": np.zeros((1, 8, 2), np.float32),
         "w1": rng.standard_normal((2, 4, 6)).astype(np.float32),
         "b1": np.zeros((2, 1, 6), np.float32),
         "w2": rng.standard_normal((2, 6, 4)).astype(np.float32),
         "b2": np.zeros((2, 1, 4), np.float32)}
    got, want = _both(lambda m, t: m.incubate.nn.functional.fused_ec_moe(
        t["x"], t["g"], t["w1"], t["b1"], t["w2"], t["b2"], "relu"), a)
    _close(got, want)
    assert np.abs(got.numpy()[0, 4:]).max() == 0.0   # tokens 4.. unpicked


def test_fused_linear_and_bias_dropout_ln_layers():
    x = np.random.default_rng(13).standard_normal((2, 8)).astype(np.float32)
    y = np.random.default_rng(14).standard_normal((2, 4, 8)).astype(
        np.float32)
    for tw in (False, True):
        jl, tl = _pair(lambda m: m.incubate.nn.FusedLinear(
            8, 16, transpose_weight=tw))
        out = tl(pt.to_tensor(x))
        assert out.shape == [2, 16]
        _close(out, jl(jt.to_tensor(x)))
    jb, tb = _pair(lambda m: m.incubate.nn.FusedBiasDropoutResidualLayerNorm(
        8, dropout_rate=0.0))
    out = tb(pt.to_tensor(y), pt.to_tensor(y))
    assert out.shape == [2, 4, 8]
    _close(out, jb(jt.to_tensor(y), jt.to_tensor(y)))


@pytest.mark.parametrize("pre", [False, True])
def test_fused_transformer_layers(pre):
    """``FusedMultiHeadAttention``, ``FusedFeedForward``,
    ``FusedTransformerEncoderLayer`` and ``FusedMultiTransformer`` with
    the reference's weights: eval outputs, and a training step's input
    gradients under one seed (dropout 0.1)."""
    x = np.random.default_rng(15).standard_normal((2, 6, 16)).astype(
        np.float32)
    makers = {
        "mha": lambda m: m.incubate.nn.FusedMultiHeadAttention(
            16, 4, dropout_rate=0.1, attn_dropout_rate=0.0,
            normalize_before=pre),
        "ffn": lambda m: m.incubate.nn.FusedFeedForward(
            16, 32, dropout_rate=0.1, normalize_before=pre),
        "enc": lambda m: m.incubate.nn.FusedTransformerEncoderLayer(
            16, 4, 32, dropout_rate=0.1, attn_dropout_rate=0.0,
            normalize_before=pre),
        "stack": lambda m: m.incubate.nn.FusedMultiTransformer(
            16, 4, 32, dropout_rate=0.1, normalize_before=pre,
            num_layers=2)}
    for name, make in makers.items():
        jl, tl = _pair(make)
        res = []
        for m, layer in ((pt, tl), (jt, jl)):
            layer.eval()
            ev = layer(m.to_tensor(x))
            layer.train()
            m.seed(6)
            xt = m.to_tensor(x, stop_gradient=False)
            out = layer(xt)
            (out * out).sum().backward()
            res.append((ev, out, xt.grad))
        for g, w in zip(*res):
            _close(g, w, 2e-5, what=name)


def _forward_grad_case(m, case):
    from_ = m.incubate.autograd
    static = m.static
    prog = static.Program()
    with static.program_guard(prog):
        if case == "square":
            x = static.data("x", shape=[3], dtype="float32")
            (jv,) = from_.forward_grad([x * x + x], [x])
            xv = np.array([1.0, 2.0, 3.0], np.float32)
            want = 2 * xv + 1
        elif case == "tangent":
            x = static.data("x", shape=[2], dtype="float32")
            jv = from_.forward_grad(m.sin(x), x, grad_inputs=np.array(
                [2.0, 0.5], np.float32))
            xv = np.array([0.3, 1.1], np.float32)
            want = np.cos(xv) * [2.0, 0.5]
        else:
            x = static.data("x", shape=[-1, 3], dtype="float32")
            (jv,) = from_.forward_grad([x * x], [x])
            xv = np.random.RandomState(0).randn(5, 3).astype(np.float32)
            want = 2 * xv
    out = static.Executor().run(prog, feed={"x": xv}, fetch_list=[jv])
    return np.asarray(out[0]), want


@pytest.mark.parametrize("case", ["square", "tangent", "dynamic_batch"])
def test_forward_grad_static(case):
    got, want = _forward_grad_case(pt, case)
    ref, _ = _forward_grad_case(jt, case)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_incubate_autograd_aliases_and_prim_switches():
    IA = pt.incubate.autograd
    assert IA.Jacobian is pt.autograd.jacobian
    assert IA.Hessian is pt.autograd.hessian
    assert IA.vjp is pt.autograd.vjp and IA.jvp is pt.autograd.jvp
    assert not IA.prim_enabled()
    IA.enable_prim()
    assert IA.prim_enabled()
    IA.disable_prim()
    assert not IA.prim_enabled()
    assert IA.to_prim("blocks") == "blocks"
    x = pt.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
    (g,) = IA.grad([(x * x).sum()], [x])
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
    with pytest.raises(TypeError, match="static Variables"):
        IA.forward_grad(x, x)


def test_train_epoch_range_resumes_after_interrupt():
    from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange
    d = tempfile.mkdtemp()
    model = pt.nn.Linear(4, 4)
    opt = pt.optimizer.AdamW(parameters=model.parameters())
    r1 = TrainEpochRange(5, "job", checkpoint_dir=d)
    r1.add("model", model).add("opt", opt)
    seen = []
    for epoch in r1:
        seen.append(epoch)
        if epoch == 2:
            break     # preempted inside epoch 2: its save never happens
    assert seen == [0, 1, 2]
    model2 = pt.nn.Linear(4, 4)
    opt2 = pt.optimizer.AdamW(parameters=model2.parameters())
    r2 = TrainEpochRange(5, "job", checkpoint_dir=d)
    r2.add("model", model2).add("opt", opt2)
    assert r2.restored_from() == 1
    assert list(r2) == [2, 3, 4]
    np.testing.assert_array_equal(model2.weight.numpy(),
                                  model.weight.numpy())


def test_identity_loss_and_the_graph_aliases():
    x = pt.to_tensor(np.array([1.0, 2.0, 6.0], np.float32))
    assert pt.incubate.identity_loss(x) is x
    assert float(pt.incubate.identity_loss(x, "sum").numpy()) == 9.0
    assert float(pt.incubate.identity_loss(x, 1).numpy()) == 9.0
    assert float(pt.incubate.identity_loss(x, "mean").numpy()) == 3.0
    for name in ("segment_sum", "segment_mean", "segment_max", "segment_min",
                 "graph_send_recv", "graph_reindex", "graph_sample_neighbors",
                 "graph_khop_sampler"):
        with pytest.raises(NotImplementedError, match="item 15.7"):
            getattr(pt.incubate, name)(x, x, x)


def test_regularizer_and_callbacks():
    p = np.array([-2.0, 0.0, 3.0], np.float32)
    g = np.array([0.5, 0.5, 0.5], np.float32)
    for name in ("L1Decay", "L2Decay"):
        got = getattr(pt.regularizer, name)(0.1)(torch.tensor(p),
                                                 torch.tensor(g))
        want = getattr(jt.regularizer, name)(0.1)(p, g)
        _close(got, want)
        assert repr(getattr(pt.regularizer, name)(0.1)) == \
            repr(getattr(jt.regularizer, name)(0.1))
    from paddle_tpu_torch.hapi import callbacks
    for name in jt.callbacks.__all__:
        assert getattr(pt.callbacks, name) is getattr(callbacks, name)

"""The port's ``hapi.Model`` against the JAX package's, on the CPU.

``llama_tiny`` in f32 is built on the JAX side from a seed and bridged
into the port (``load_jax_params``); both train on the same seeded
token rows (inputs the first 16 ids of a row, labels the last 16) with
``AdamW(1e-3)`` and ``nn.CrossEntropyLoss()``. Tolerances are ROADMAP
Queue 3's Adam rule: per-step losses within 1e-5 and trained weights
within 0.02 lr (two BLAS summation orders; XLA's fused multiply-adds).

- supervised ``fit`` (the port with 2 fork workers): losses, final
  weights and the last checkpoint (read by the reference's
  ``read_checkpoint``: the same keys, cursor, step count and fit key
  chain bit for bit) agree; plain ``fit`` (a shuffled loader on numpy's
  global stream), ``evaluate`` and ``predict`` agree;
- a JAX supervised fit preempted at step 3 resumes in the port, whose
  remaining losses and final weights match the reference's
  uninterrupted run;
- ``train_batch``, ``eval_batch`` and ``predict_batch``; ``save`` /
  ``load`` across the two packages, parameters bit for bit;
- pins of ROADMAP Queue 3 on a 4-8-1 MLP: ``fit`` ignores the
  optimizer's gradient clip and its decay exemptions (the reference's
  functional update), and its step count, which bias-corrects the next
  update, advances over a skipped NaN step; and every optimizer's
  ``functional()`` update of bf16 parameters equals the reference's op
  by op, bit for bit (the rate weakly typed).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.reliability import TrainSupervisor as JTrainSupervisor
from paddle_tpu.reliability import ckpt as jckpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                     llama_tiny, load_jax_params)
from paddle_tpu_torch.reliability import TrainSupervisor

LR = 1e-3
LOSS_TOL = 1e-5
W_TOL = 0.02 * LR


@functools.lru_cache(maxsize=1)
def _weights():
    jpt.seed(21)
    return {n: p.numpy() for n, p in JaxLlama(jax_llama_tiny())
            .named_parameters()}


def _rows(n=24, seed=0):
    rows = np.random.default_rng(seed).integers(0, 256, (n, 17))
    return rows[:, :16], rows[:, 1:]


def _jax_model(**opt):
    jpt.seed(21)
    net = JaxLlama(jax_llama_tiny())
    m = jpt.Model(net)
    m.prepare(optimizer=jpt.optimizer.AdamW(LR, parameters=net.parameters(),
                                            **opt),
              loss=jnn.CrossEntropyLoss())
    return m


def _port_model(**opt):
    net = load_jax_params(LlamaForCausalLM(llama_tiny(), device="cpu"),
                          _weights())
    return tpt.Model(net).prepare(
        optimizer=topt.AdamW(LR, parameters=net.named_parameters(), **opt),
        loss=tnn.CrossEntropyLoss())


class _Rec:
    def __init__(self, hook=None):
        self.losses = []
        self.hook = hook

    def set_model(self, m):
        pass

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])
        if self.hook:
            self.hook(len(self.losses))


def _jax_params(m):
    return {n: np.asarray(v) for n, v in m._params.items()}


def _assert_weights(port, want, tol=W_TOL):
    got = export_params(port) if not isinstance(port, dict) else port
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=tol,
                                   err_msg=n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The reference's uninterrupted supervised fit (one epoch, 6 steps,
    a checkpoint every 4) and its run preempted after step 3."""
    x, y = _rows()
    d = tmp_path_factory.mktemp("jax")
    rec, m = _Rec(), _jax_model()
    m.fit(JTensorDataset([x, y]), batch_size=4, epochs=1, verbose=0,
          callbacks=[rec], supervisor=JTrainSupervisor(
              str(d / "full"), save_interval_steps=4))
    sup = JTrainSupervisor(str(d / "cut"), save_interval_steps=4)
    cut = _Rec(hook=lambda n: n == 3 and sup.request_preemption())
    _jax_model().fit(JTensorDataset([x, y]), batch_size=4, epochs=1,
                     verbose=0, callbacks=[cut], supervisor=sup)
    return {"losses": rec.losses, "params": _jax_params(m),
            "full_dir": d / "full", "cut_dir": d / "cut",
            "cut_losses": cut.losses}


def test_supervised_fit_matches_reference(jax_run, tmp_path):
    x, y = _rows()
    rec, m = _Rec(), _port_model()
    sup = TrainSupervisor(str(tmp_path), save_interval_steps=4)
    m.fit(TensorDataset([x, y]), batch_size=4, epochs=1, verbose=0,
          num_workers=2, callbacks=[rec], supervisor=sup)
    assert len(rec.losses) == 6
    np.testing.assert_allclose(rec.losses, jax_run["losses"], rtol=0,
                               atol=LOSS_TOL)
    _assert_weights(m.network, jax_run["params"])
    # the port's last checkpoint, read by the reference, beside the
    # reference's own: the same tree, meta and key chain
    mine = jckpt.read_checkpoint(sup.store.step_path(6))
    theirs = jckpt.read_checkpoint(
        JTrainSupervisor(str(jax_run["full_dir"])).store.step_path(6))
    assert set(mine[0]) == set(theirs[0]) == {"params", "opt_state"}
    _assert_weights({n: np.asarray(v) for n, v in
                     mine[0]["params"].items()}, jax_run["params"])
    for k in ("m", "v"):
        assert set(mine[0]["opt_state"][k]) == set(theirs[0]["opt_state"][k])
    for k in ("step_count", "cursor", "step"):
        assert mine[1][k] == theirs[1][k]
    np.testing.assert_array_equal(mine[1]["fit_rng"], theirs[1]["fit_rng"])
    assert np.asarray(mine[1]["fit_rng"]).dtype == np.uint32


def test_jax_run_preempted_resumes_in_the_port(jax_run):
    assert len(jax_run["cut_losses"]) == 3
    rec, m = _Rec(), _port_model()
    x, y = _rows()
    m.fit(TensorDataset([x, y]), batch_size=4, epochs=1, verbose=0,
          callbacks=[rec], supervisor=TrainSupervisor(
              str(jax_run["cut_dir"]), save_interval_steps=4))
    assert m._step_count == 6 and len(rec.losses) == 3
    np.testing.assert_allclose(rec.losses, jax_run["losses"][3:], rtol=0,
                               atol=LOSS_TOL)
    _assert_weights(m.network, jax_run["params"])


def test_plain_fit_evaluate_predict_match_reference():
    x, y = _rows()
    xe, ye = _rows(8, seed=1)
    out = {}
    for name, make, ds in (
            ("jax", _jax_model, JTensorDataset),
            ("torch", _port_model, TensorDataset)):
        np.random.seed(0)
        rec, m = _Rec(), make()
        m.fit(ds([x, y]), batch_size=4, epochs=1, verbose=0,
              callbacks=[rec])
        out[name] = (rec.losses, m.evaluate(ds([xe, ye]), batch_size=4),
                     m.predict(ds([xe]), batch_size=4, stack_outputs=True),
                     m)
    (jl, je, jp, jm), (tl, te, tp, tm) = out["jax"], out["torch"]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    _assert_weights(tm.network, _jax_params(jm))
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=0,
                               atol=LOSS_TOL)
    assert tp[0].shape == (8, 16, 256)
    np.testing.assert_allclose(tp[0], jp[0], rtol=0, atol=1e-4)


def test_batch_entry_points_match_reference():
    x, y = _rows(8)
    jm, tm = _jax_model(), _port_model()
    for i in range(2):
        sl = slice(4 * i, 4 * i + 4)
        np.testing.assert_allclose(tm.train_batch([x[sl]], [y[sl]]),
                                   jm.train_batch([x[sl]], [y[sl]]),
                                   rtol=0, atol=LOSS_TOL)
    assert tm._step_count == 2
    _assert_weights(tm.network, _jax_params(jm))
    np.testing.assert_allclose(tm.eval_batch([x[:4]], [y[:4]]),
                               jm.eval_batch([x[:4]], [y[:4]]), rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(tm.predict_batch([x[:4]])[0],
                               jm.predict_batch([x[:4]])[0], rtol=0,
                               atol=1e-4)


def test_save_load_across_frameworks(tmp_path):
    x, y = _rows(4)
    tm = _port_model()
    tm.train_batch([x], [y])
    tm.save(str(tmp_path / "port"))
    jm = _jax_model()
    jm.load(str(tmp_path / "port"))
    for n, v in jm.network.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), export_params(tm.network)[n])
    opt = jpt.load(str(tmp_path / "port.pdopt"))
    assert opt["step"] == 1 and set(opt["state"]) == {"m", "v"}
    jm.train_batch([x], [y])
    jm.save(str(tmp_path / "jax"))
    back = _port_model()
    back.load(str(tmp_path / "jax"))
    want = {n: v.numpy() for n, v in jm.network.state_dict().items()}
    _assert_weights(back.network, want, tol=0)
    assert back._params is None                 # rebuilt at the next step
    back.train_batch([x], [y])


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"),
                                 float("-inf")])
def test_guard_flag_over_mixed_tensors(bad):
    """The guarded step's one-pass finiteness flag: bf16 and f32 tensors
    at the top of bf16's range are finite; one bad element anywhere is
    not."""
    from paddle_tpu_torch.hapi.model import _all_finite
    ts = [torch.full((5, 3), 3.0e38).bfloat16(), torch.randn(7),
          torch.randn(2, 2).bfloat16()]
    if bad is not None:
        ts[1][4] = bad
    assert _all_finite(ts).item() is (bad is None)


def test_set_state_dict_keys_and_shapes():
    m = LlamaForCausalLM(llama_tiny(), device="cpu")
    sd = {n: v.numpy() for n, v in JaxLlama(jax_llama_tiny())
          .state_dict().items()}
    missing, unexpected = m.set_state_dict(dict(sd, extra=np.zeros(1)))
    assert missing == [] and unexpected == ["extra"]
    _assert_weights(m, sd, tol=0)
    lin = tnn.Linear(3, 2, device="cpu")
    assert lin.set_state_dict({"weight": np.ones((3, 2))}) == (["bias"], [])
    with pytest.raises(ValueError, match="shape"):
        lin.set_state_dict({"weight": np.ones((2, 3))})


# ------------------------------------------------ Queue 3 pins (MLP)
def _mlp_pair(jax_opt=None, port_opt=None):
    jpt.seed(7)
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 1))
    tnet = torch.nn.Sequential(tnn.Linear(4, 8, device="cpu"),
                               torch.nn.ReLU(),
                               tnn.Linear(8, 1, device="cpu"))
    load_jax_params(tnet, {n: p.numpy() for n, p in jnet.named_parameters()})
    jm = jpt.Model(jnet).prepare(
        optimizer=jpt.optimizer.AdamW(0.01, parameters=jnet.parameters(),
                                      **(jax_opt or {})),
        loss=jnn.BCEWithLogitsLoss())
    tm = tpt.Model(tnet).prepare(
        optimizer=topt.AdamW(0.01, parameters=tnet.named_parameters(),
                             **(port_opt or {})),
        loss=tnn.BCEWithLogitsLoss())
    return jm, tm


def _mlp_data(poison=False):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 4)).astype(np.float32)
    y = (x.sum(-1, keepdims=True) > 0).astype(np.float32)
    if poison:
        y[8:16] = np.nan                   # batch 1 of 3
    return x, y


def _fit(m, ds, sup, tmp_path, poison=False):
    x, y = _mlp_data(poison)
    rec = _Rec()
    m.fit(ds([x, y]), batch_size=8, epochs=1, shuffle=False, verbose=0,
          callbacks=[rec], supervisor=sup(str(tmp_path),
                                          save_interval_steps=100))
    return rec.losses


def _fit_pair(jm, tm, tmp_path, poison=False):
    return (_fit(jm, JTensorDataset, JTrainSupervisor, tmp_path / "jax",
                 poison),
            _fit(tm, TensorDataset, TrainSupervisor, tmp_path / "torch",
                 poison))


def test_fit_ignores_clip_and_decay_exemptions_as_the_reference(tmp_path):
    """ROADMAP Queue 3: the reference's functional update never clips and
    decays every parameter; ``Optimizer.step`` does both. fit follows
    the functional update: a tiny clip and a decay function exempting
    the biases change nothing, and the reference agrees."""
    exempt = dict(weight_decay=0.5,
                  apply_decay_param_fun=lambda name: "bias" not in name)
    jm, tm = _mlp_pair(
        dict(exempt, grad_clip=jnn.ClipGradByGlobalNorm(1e-4)),
        dict(exempt, grad_clip=tnn.ClipGradByGlobalNorm(1e-4)))
    jl, tl = _fit_pair(jm, tm, tmp_path / "a")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    _assert_weights(tm.network, _jax_params(jm), tol=0.02 * 0.01)
    plain = _mlp_pair(port_opt=dict(weight_decay=0.5))[1]
    _fit(plain, TensorDataset, TrainSupervisor, tmp_path / "b")
    for a, b in zip(tm.parameters(), plain.parameters()):
        assert torch.equal(a, b)


def test_step_count_advances_over_a_skipped_step(tmp_path):
    """ROADMAP Queue 3: a skipped NaN step still advances the model's
    step count, so the next committed update bias-corrects with step 3
    (the optimizer's own count would say 2), as in the reference."""
    jm, tm = _mlp_pair()
    jl, tl = _fit_pair(jm, tm, tmp_path, poison=True)
    assert np.isnan(tl[1]) and np.isnan(jl[1])
    np.testing.assert_allclose([tl[0], tl[2]], [jl[0], jl[2]], rtol=0,
                               atol=LOSS_TOL)
    assert tm._step_count == jm._step_count == 3
    assert tm._optimizer._step_count == 0      # never optimizer.step()
    _assert_weights(tm.network, _jax_params(jm), tol=0.02 * 0.01)


@pytest.mark.parametrize("name,kw", [
    ("SGD", {}), ("SGD", {"weight_decay": 0.1}), ("Momentum", {}),
    ("Momentum", {"use_nesterov": True, "weight_decay": 0.1}),
    ("Adam", {"weight_decay": 0.1}), ("AdamW", {}), ("Adamax", {}),
    ("Adagrad", {}), ("Adadelta", {}), ("RMSProp", {}),
    ("RMSProp", {"centered": True, "momentum": 0.9}), ("Lamb", {}),
    ("LarsMomentum", {})])
def test_functional_update_of_bf16_parameters_equals_reference(name, kw):
    """ROADMAP Queue 3: the reference's functional update takes the rate
    as a weakly typed scalar, so where it meets a bf16 tensor the
    product stays bf16 (the object API's rate is a strong f32). Three
    updates of bf16 parameters, each with its wd mask, against the
    reference run op by op (XLA's CPU jit keeps bf16 intermediates in
    f32)."""
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.standard_normal((2, 64)), jnp.bfloat16)
    grads = [jnp.asarray(0.3 * rng.standard_normal((2, 64)), jnp.bfloat16)
             for _ in range(3)]
    mask = {"a": True, "b": False}
    jinit, jupd = getattr(jpt.optimizer, name)(0.1, **kw).functional()
    jp = {"a": p[0], "b": p[1]}
    js = jinit(jp)
    with jax.disable_jit():
        for i, g in enumerate(grads, 1):
            jp, js = jupd({"a": g[0], "b": g[1]}, jp, js, lr=0.1,
                          step=jnp.asarray(i, jnp.int32), wd_mask=mask)
    tinit, tupd = getattr(topt, name)(0.1, **kw).functional()

    def port(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()

    tp = {"a": port(p[0]), "b": port(p[1])}
    ts = tinit(tp)
    for i, g in enumerate(grads, 1):
        assert tupd({"a": port(g[0]), "b": port(g[1])}, tp, ts, lr=0.1,
                    step=i, wd_mask=mask) == (tp, ts)
    for k in ("a", "b"):
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(jp[k], np.float32))

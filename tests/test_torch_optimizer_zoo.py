"""The port's optimizer zoo, its train step with a clip and a scheduler,
and the optimizer-state bridge against the JAX package, on the CPU.

- every optimizer of the zoo (SGD, Momentum with and without Nesterov,
  Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp plain and centered,
  Lamb, LarsMomentum), f32 and bf16 parameters of ``llama_tiny``'s
  shapes, three steps with a ``StepDecay`` scheduler and a clip, against
  the reference's ``Optimizer.step`` on the same seeded gradients. f32
  cases take the clips by value, by norm and by global norm in turn;
  bf16 cases clip by value: a norm summed in another order moves a
  clipped bf16 gradient by an ulp now and then, and where an optimizer's
  weight decay cancels that gradient the update flips sign.
  Optimizers with bf16 intermediates are held to the reference run op by
  op (``jax.disable_jit``), as its code rounds: XLA's CPU program keeps
  them in f32 (excess precision), which a bf16 device does not; Adam,
  AdamW, Lamb and LarsMomentum, whose updates are all f32, run jitted as
  the reference's fused step runs them (its bias corrections are f32
  ``pow``, as the port's; op by op JAX multiplies them out). The rule
  (ROADMAP, Queue 3): bit for bit where no norm and no jitted program is
  involved; else f32 within 8 ulps of each tensor's largest value (norms
  summed in another order, XLA's contracted multiply-adds), bf16 at most
  one bf16 ulp apart on at most 0.1% of the elements (such an f32
  difference crossing a bf16 rounding midpoint);
- three steps of ``jit.train_step_fn`` + ``AdamW`` with
  ``ClipGradByGlobalNorm`` and a ``LinearWarmup(CosineAnnealingDecay)``
  scheduler on ``llama_tiny`` against ``paddle_tpu.jit.train_step_fn``
  (which clips by the global norm whatever the clip's class,
  ``jit/__init__.py:166-170``; the two agree for this clip): losses
  within 1e-5, weights within 0.02 lr, each step's lr the scheduler's;
- the bridge: two JAX ``Optimizer.step``s (AdamW, bf16 parameters with
  ``multi_precision``, a scheduler), the parameters and the optimizer
  state (m, v, master, step, ``LR_Scheduler``) carried into the port as
  numpy arrays, and the third step taken by the port: the reference's
  third step within the rule above (bf16 parameters; masters, m and v
  within the Adam rule); ``export_optimizer_state`` gives the same
  arrays back.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core.tensor import Parameter, wrap
from paddle_tpu.jit import train_step_fn as jax_train_step_fn
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import train_step_fn
from paddle_tpu_torch.models import (LlamaForCausalLM, export_optimizer_state,
                                     export_params, llama_tiny,
                                     load_jax_params, load_optimizer_state)

LR = 0.01
F32_ULPS = 2.5e-7


@functools.lru_cache(maxsize=1)
def _shapes():
    return [(n, tuple(p.shape)) for n, p in
            LlamaForCausalLM(llama_tiny(), device="cpu").named_parameters()]


ZOO = {"SGD": ("SGD", {"weight_decay": 0.01}),
       "Momentum": ("Momentum", {"weight_decay": 0.01}),
       "Momentum-nesterov": ("Momentum", {"use_nesterov": True}),
       "Adam": ("Adam", {"weight_decay": 0.01}),
       "AdamW": ("AdamW", {}),
       "Adamax": ("Adamax", {"weight_decay": 0.01}),
       "Adagrad": ("Adagrad", {"weight_decay": 0.01}),
       "Adadelta": ("Adadelta", {"weight_decay": 0.01}),
       "RMSProp": ("RMSProp", {"weight_decay": 0.01}),
       "RMSProp-centered": ("RMSProp", {"centered": True, "momentum": 0.5}),
       "Lamb": ("Lamb", {"exclude_from_weight_decay_fn":
                         lambda p: p.ndim == 1}),
       "LarsMomentum": ("LarsMomentum", {})}
CLIPS = ("value", "norm", "global")
CASES = [(name, dtype, CLIPS[i % 3] if dtype == "float32" else "value")
         for i, name in enumerate(ZOO) for dtype in ("float32", "bfloat16")]
ALL_F32 = ("Adam", "AdamW", "Lamb", "LarsMomentum")


def _clip(kind, mod):
    return {"value": lambda: mod.ClipGradByValue(0.02),
            "norm": lambda: mod.ClipGradByNorm(0.5),
            "global": lambda: mod.ClipGradByGlobalNorm(1.0)}[kind]()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    ps = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for n, s in _shapes()}
    gs = [{n: (rng.standard_normal(s) * 0.05).astype(np.float32)
           for n, s in _shapes()} for _ in range(3)]
    return ps, gs


@pytest.mark.parametrize("name,dtype,clip", CASES,
                         ids=[f"{n}-{d}-{c}" for n, d, c in CASES])
def test_zoo_matches_the_reference_update(name, dtype, clip):
    cls, kw = ZOO[name]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ps, gs = _data()
    names = [n for n, _ in _shapes()]
    jparams = [Parameter(jnp.asarray(ps[n]).astype(jdt), name=n)
               for n in names]
    # copies: a tensor that shared ps[n]'s memory would write the JAX
    # side's parameter too, wherever jnp.asarray aliased the same buffer
    tparams = [(n, torch.nn.Parameter(torch.tensor(ps[n], dtype=tdt)))
               for n in names]
    jsched = pt.optimizer.lr.StepDecay(LR, step_size=1, gamma=0.5)
    tsched = topt.lr.StepDecay(LR, step_size=1, gamma=0.5)
    jopt = getattr(pt.optimizer, cls)(learning_rate=jsched,
                                      parameters=jparams,
                                      grad_clip=_clip(clip, pt.nn), **kw)
    topt_ = getattr(topt, cls)(learning_rate=tsched, parameters=tparams,
                               grad_clip=_clip(clip, tnn), **kw)
    jitted = cls in ALL_F32
    for g in gs:
        for p in jparams:
            p.grad = wrap(jnp.asarray(g[p.name]).astype(jdt))
        for n, p in tparams:
            p.grad = torch.tensor(g[n], dtype=tdt)
        if jitted:
            jopt.step()
        else:
            with jax.disable_jit():
                jopt.step()
        topt_.step()
        jopt.clear_grad()
        topt_.clear_grad()
        jsched.step()
        tsched.step()
    _hold({jp.name: jp._value for jp in jparams}, dict(tparams), tdt,
          exact=not jitted and clip == "value")
    assert all(p.grad is None for _, p in tparams)
    assert topt_.state_dict()["step"] == 3
    st, jst = topt_.state_dict()["state"], jopt.state_dict()["state"]
    assert set(st) == set(jst)
    for sname in st:
        for k, t in st[sname].items():
            assert t.dtype == (torch.float32 if t.numel() == 0
                               else getattr(torch, str(np.asarray(
                                   jst[sname][k]).dtype))), (sname, k)


def _hold(want, got, tdt, exact):
    """The zoo's rule (module docstring) for the parameters ``got``
    (name: port tensor) against ``want`` (name: JAX array)."""
    differ = total = 0
    for n, tp in got.items():
        assert tp.dtype == tdt
        w = np.asarray(want[n].astype(jnp.float32))
        a = tp.detach().float().numpy()
        if exact:
            np.testing.assert_array_equal(a, w, err_msg=n)
        elif tdt == torch.float32:
            np.testing.assert_allclose(
                a, w, rtol=0, atol=8 * np.spacing(np.abs(w).max()),
                err_msg=n)
        else:
            np.testing.assert_allclose(a, w, rtol=2 ** -7, atol=0,
                                       err_msg=n)
            differ += int((a != w).sum())
        total += a.size
    assert differ <= 1e-3 * total, (differ, total)


def _jax_model():
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    return jm


def _jax_loss(logits, labels):
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    return -jnp.take_along_axis(logp, labels[:, 1:, None], -1).mean()


def _warmup_cosine(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(3e-3, T_max=10),
                            warmup_steps=2, start_lr=1e-3, end_lr=3e-3)


def test_train_step_with_a_global_clip_and_a_scheduler_matches_jax():
    jm = _jax_model()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    ids = np.random.default_rng(10).integers(0, 256, (2, 24)).astype(
        np.int32)
    jsched, tsched = _warmup_cosine(pt.optimizer.lr), _warmup_cosine(topt.lr)
    jopt = pt.optimizer.AdamW(learning_rate=jsched,
                              parameters=jm.parameters(),
                              grad_clip=pt.nn.ClipGradByGlobalNorm(0.5))
    jstep = jax_train_step_fn(jm, _jax_loss, jopt, donate=False)
    params = jm.raw_params()
    state = jopt.functional()[0](params)
    opt = topt.AdamW(learning_rate=tsched, parameters=tm.named_parameters(),
                     grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    step = train_step_fn(tm, tm.loss, opt)
    jl, tl, lrs = [], [], []
    for i in range(3):
        batch = {"inputs": (jnp.asarray(ids),), "labels": (jnp.asarray(ids),)}
        loss, params, state = jstep(params, state, batch, i + 1,
                                    lr=jnp.asarray(jsched(), jnp.float32))
        jl.append(float(loss))
        lrs.append(opt.get_lr())
        tl.append(step({"inputs": (torch.from_numpy(ids),),
                        "labels": (torch.from_numpy(ids).long(),)}).item())
        jsched.step()
        tsched.step()
    assert lrs == [tsched.get_lr_at(k) for k in range(3)]
    scale, gn = opt._clip_info.tolist()
    assert scale < 1.0 and abs(scale * gn - 0.5) < 1e-6
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    got = export_params(tm)
    for n, a in got.items():
        np.testing.assert_allclose(a, np.asarray(params[n]), rtol=0,
                                   atol=0.02 * 3e-3, err_msg=n)


def test_optimizer_state_crosses_the_bridge_mid_run():
    """Two reference steps, the state carried over as numpy arrays, the
    third step in the port: the reference's third step."""
    ps, gs = _data(4)
    names = [n for n, _ in _shapes()]
    jparams = [Parameter(jnp.asarray(ps[n]).astype(jnp.bfloat16), name=n)
               for n in names]
    jsched = pt.optimizer.lr.CosineAnnealingDecay(LR, T_max=5)
    jopt = pt.optimizer.AdamW(learning_rate=jsched, parameters=jparams,
                              multi_precision=True,
                              apply_decay_param_fun=lambda n: "norm" not in n)
    for g in gs[:2]:
        for p in jparams:
            p.grad = wrap(jnp.asarray(g[p.name]).astype(jnp.bfloat16))
        jopt.step()
        jopt.clear_grad()
        jsched.step()
    sd = jopt.state_dict()
    carried = {"step": sd["step"], "LR_Scheduler": sd["LR_Scheduler"],
               "state": {s: {k: np.asarray(v.astype(jnp.float32)) for k, v in
                             tree.items()} for s, tree in sd["state"].items()}}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", dtype=torch.bfloat16)
    load_jax_params(tm, {p.name: np.asarray(p._value.astype(jnp.float32))
                         for p in jparams})
    tsched = topt.lr.CosineAnnealingDecay(LR, T_max=5)
    opt = topt.AdamW(learning_rate=tsched, parameters=tm.named_parameters(),
                     multi_precision=True,
                     apply_decay_param_fun=lambda n: "norm" not in n)
    load_optimizer_state(opt, carried)
    assert tsched.last_epoch == jsched.last_epoch == 2
    back = export_optimizer_state(opt)
    assert back["step"] == 2 and back["LR_Scheduler"] == sd["LR_Scheduler"]
    for s, tree in carried["state"].items():
        for k, a in tree.items():
            np.testing.assert_array_equal(back["state"][s][k], a)
    for p in jparams:
        p.grad = wrap(jnp.asarray(gs[2][p.name]).astype(jnp.bfloat16))
    jopt.step()
    for n, p in tm.named_parameters():
        p.grad = torch.from_numpy(gs[2][n]).bfloat16()
    opt.step()
    _hold({p.name: p._value for p in jparams}, dict(tm.named_parameters()),
          torch.bfloat16, exact=False)
    st = opt.state_dict()["state"]
    jst = jopt.state_dict()["state"]
    for s in ("m", "v", "master"):
        for k, t in st[s].items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jst[s][k]),
                                       rtol=F32_ULPS, atol=1e-5 * LR)
    assert opt.state_dict()["step"] == 3

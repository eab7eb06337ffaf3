"""The port's learning-rate schedulers, gradient clips and optimizer base
against the JAX package's, on the CPU.

- every scheduler of ``optimizer.lr`` over 30 steps from the same
  arguments: each step's lr, ``get_lr_at`` at every step and the
  ``state_dict`` equal to the reference's bit for bit (Python floats on
  both sides), and a scheduler rebuilt from the state dict goes on
  alike;
- the three clips on seeded f32 and bf16 gradients against
  ``paddle_tpu.nn.ClipGradBy*.clip_values``: by value bit for bit; by
  norm and by global norm (sums of squares taken in another order by
  another library) f32 within two ulps of the gradient, bf16 at most one
  bf16 ulp apart, and the clipped bf16 gradient is a bf16 value (rounded
  back after the f32 product, ``clip.py:43``); ``clip_by_global_norm_tree``
  likewise, with its norm within two f32 ulps;
- the optimizer base: a learning rate that is neither a number nor a
  scheduler raises ``TypeError``; ``set_lr`` with a scheduler raises
  ``RuntimeError``; ``state_dict`` carries ``"LR_Scheduler"`` and
  ``set_state_dict`` restores it; ``Adam(lazy_mode=True)`` and
  ``AdamW(lr_ratio=...)`` are accepted and change nothing, as in the
  reference.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt


def _sched(mod, name):
    """The scheduler ``name`` built from ``mod`` (either package's
    ``optimizer.lr``) with fixed arguments."""
    cases = {
        "NoamDecay": lambda: mod.NoamDecay(64, 5, learning_rate=1.0),
        "PiecewiseDecay": lambda: mod.PiecewiseDecay(
            [5, 10, 20], [0.1, 0.05, 0.01, 0.001]),
        "NaturalExpDecay": lambda: mod.NaturalExpDecay(0.1, gamma=0.1),
        "InverseTimeDecay": lambda: mod.InverseTimeDecay(0.1, gamma=0.2),
        "PolynomialDecay": lambda: mod.PolynomialDecay(
            0.1, 10, end_lr=0.001, power=2.0),
        "PolynomialDecay-cycle": lambda: mod.PolynomialDecay(
            0.1, 7, end_lr=0.001, cycle=True),
        "LinearWarmup": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(3e-4, T_max=100), warmup_steps=5,
            start_lr=0.0, end_lr=3e-4),
        "LinearWarmup-number": lambda: mod.LinearWarmup(
            0.1, warmup_steps=8, start_lr=0.01, end_lr=0.1),
        "ExponentialDecay": lambda: mod.ExponentialDecay(0.1, 0.9),
        "MultiStepDecay": lambda: mod.MultiStepDecay(0.1, [3, 8, 15], 0.5),
        "StepDecay": lambda: mod.StepDecay(0.1, 4, 0.5),
        "LambdaDecay": lambda: mod.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "ReduceOnPlateau": lambda: mod.ReduceOnPlateau(
            0.1, patience=2, factor=0.5, cooldown=1),
        "CosineAnnealingDecay": lambda: mod.CosineAnnealingDecay(
            0.1, T_max=10, eta_min=0.001),
        "MultiplicativeDecay": lambda: mod.MultiplicativeDecay(
            0.1, lambda e: 0.9),
        "OneCycleLR": lambda: mod.OneCycleLR(0.1, total_steps=30),
        "OneCycleLR-linear": lambda: mod.OneCycleLR(
            0.1, total_steps=24, anneal_strategy="linear"),
        "CyclicLR": lambda: mod.CyclicLR(0.01, 0.1, 4, step_size_down=6,
                                         mode="triangular2"),
        "CyclicLR-exp_range": lambda: mod.CyclicLR(
            0.01, 0.1, 5, mode="exp_range", exp_gamma=0.9),
        "CosineAnnealingWarmRestarts": lambda: mod.CosineAnnealingWarmRestarts(
            0.1, T_0=5, T_mult=2, eta_min=0.001),
    }
    return cases[name]()


NAMES = ["NoamDecay", "PiecewiseDecay", "NaturalExpDecay", "InverseTimeDecay",
         "PolynomialDecay", "PolynomialDecay-cycle", "LinearWarmup",
         "LinearWarmup-number", "ExponentialDecay", "MultiStepDecay",
         "StepDecay", "LambdaDecay", "ReduceOnPlateau",
         "CosineAnnealingDecay", "MultiplicativeDecay", "OneCycleLR",
         "OneCycleLR-linear", "CyclicLR", "CyclicLR-exp_range",
         "CosineAnnealingWarmRestarts"]


def _walk(s, metrics):
    lrs = [s()]
    for m in metrics:
        if m is None:
            s.step()
        else:
            s.step(m)
        lrs.append(s())
    return lrs


@pytest.mark.parametrize("name", NAMES)
def test_scheduler_matches_the_reference_over_30_steps(name):
    plateau = name == "ReduceOnPlateau"
    rng = np.random.default_rng(3)
    metrics = ([float(x) for x in 1.0 + rng.random(30) * (rng.random(30) > .5)]
               if plateau else [None] * 30)
    ref, got = _sched(pt.optimizer.lr, name), _sched(topt.lr, name)
    want = _walk(ref, metrics)
    assert _walk(got, metrics) == want
    assert got.state_dict() == ref.state_dict()
    if not plateau:
        assert [got.get_lr_at(k) for k in range(30)] == \
            [ref.get_lr_at(k) for k in range(30)]
        assert got() == want[-1]            # get_lr_at leaves the state
    again = _sched(topt.lr, name)
    again.set_state_dict(got.state_dict())
    assert again.state_dict() == got.state_dict()
    if not plateau:
        again.step()
        ref.step()
        assert again() == ref()


def test_the_scheduler_base_has_no_rule():
    with pytest.raises(NotImplementedError):
        topt.lr.LRScheduler(0.1)
    with pytest.raises(NotImplementedError):
        pt.optimizer.lr.LRScheduler(0.1)
    assert sorted(topt.lr.__all__) == sorted(pt.optimizer.lr.__all__)


_SHAPES = [(8, 16), (16,), (4, 4, 4), (33, 7)]


def _grads(dtype, seed=5, scale=1.0):
    rng = np.random.default_rng(seed)
    out = [(rng.standard_normal(s) * scale * 10.0 ** -rng.integers(0, 3))
           .astype(np.float32) for s in _SHAPES]
    if dtype == "bfloat16":      # representable on both sides
        out = [torch.tensor(a).bfloat16().float().numpy() for a in out]
    return out


def _clips(kind, mod):
    return {"value": lambda: mod.ClipGradByValue(0.3, min=-0.2),
            "norm": lambda: mod.ClipGradByNorm(0.5),
            "global": lambda: mod.ClipGradByGlobalNorm(0.2)}[kind]()


def _hold(got, want, dtype, exact):
    """Clipped gradients: bit for bit where ``exact``; else f32 within two
    ulps of the gradient, bf16 at most one bf16 ulp apart."""
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        a = g.float().numpy()
        if exact:
            np.testing.assert_array_equal(a, w)
        elif dtype == "float32":
            np.testing.assert_allclose(a, w, rtol=2.5e-7, atol=1e-30)
        else:
            np.testing.assert_allclose(a, w, rtol=2 ** -7, atol=1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["value", "norm", "global"])
def test_clip_matches_the_reference(kind, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    gs = _grads(dtype)
    want = _clips(kind, pt.nn).clip_values(
        [jnp.asarray(a).astype(jdt) for a in gs])
    got = _clips(kind, tnn).clip_values([torch.tensor(a).to(tdt) for a in gs])
    assert all(g.dtype == tdt for g in got)
    _hold(got, want, dtype, exact=kind == "value")
    if kind != "value":      # the clip is active on some tensor
        assert any(not np.array_equal(g.float().numpy(), a)
                   for g, a in zip(got, gs))
    pairs = [(object(), torch.tensor(a).to(tdt)) for a in gs]
    out = _clips(kind, tnn)(pairs)
    assert [p for p, _ in out] == [p for p, _ in pairs]
    for (_, g), c in zip(out, got):
        assert torch.equal(g, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_tree_matches_the_reference(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    gs = _grads(dtype, seed=6, scale=3.0)
    jtree = {"a": [jnp.asarray(gs[0]).astype(jdt)],
             "b": (jnp.asarray(gs[1]).astype(jdt),
                   jnp.asarray(gs[2]).astype(jdt))}
    ttree = {"a": [torch.tensor(gs[0]).to(tdt)],
             "b": (torch.tensor(gs[1]).to(tdt), torch.tensor(gs[2]).to(tdt))}
    wtree, wn = pt.nn.clip.clip_by_global_norm_tree(jtree, 1.0)
    gtree, gn = tnn.clip_by_global_norm_tree(ttree, 1.0)
    np.testing.assert_allclose(gn.item(), float(wn), rtol=2.5e-7)
    assert isinstance(gtree["b"], tuple) and isinstance(gtree["a"], list)
    _hold(jax.tree_util.tree_leaves(gtree), jax.tree_util.tree_leaves(wtree),
          dtype, exact=False)
    ext = tnn.ClipGradByGlobalNorm(1.0).clip_values(
        [t for t in (ttree["a"][0],)], extra_sq_norm=torch.tensor(4.0))
    want = pt.nn.ClipGradByGlobalNorm(1.0).clip_values(
        [jtree["a"][0]], extra_sq_norm=jnp.float32(4.0))
    _hold(ext, want, dtype, exact=False)


def _param(seed=0, n=12):
    return torch.nn.Parameter(torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n).astype(np.float32)))


def test_learning_rate_must_be_a_number_or_a_scheduler():
    with pytest.raises(TypeError, match="LRScheduler"):
        topt.AdamW(learning_rate=object())
    with pytest.raises(TypeError, match="LRScheduler"):
        topt.SGD(learning_rate="0.1")
    opt = topt.SGD(learning_rate=topt.lr.StepDecay(0.1, 2),
                   parameters=[_param()])
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)


def test_state_dict_carries_the_scheduler():
    """``"LR_Scheduler"`` in the state dict, as the reference's
    (``optimizer.py:167-189``), restored by ``set_state_dict``; the step
    reads the scheduler's current lr."""
    sched = topt.lr.StepDecay(0.1, 2, 0.5)
    p = _param()
    opt = topt.SGD(learning_rate=sched, parameters=[p])
    before = p.detach().clone()
    for _ in range(3):
        p.grad = torch.ones_like(p)
        opt.step()
        sched.step()
    # lr 0.1, 0.1, 0.05 over the three steps
    want = before - np.float32(0.1) - np.float32(0.1) - np.float32(0.05)
    torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-6)
    sd = opt.state_dict()
    ref = pt.optimizer.SGD(learning_rate=pt.optimizer.lr.StepDecay(0.1, 2,
                                                                   0.5))
    for _ in range(3):
        ref._lr.step()
    ref._step_count = 3
    assert sd["LR_Scheduler"] == ref.state_dict()["LR_Scheduler"]
    fresh_sched = topt.lr.StepDecay(0.1, 2, 0.5)
    fresh = topt.SGD(learning_rate=fresh_sched, parameters=[p])
    fresh.set_state_dict(sd)
    assert fresh_sched.last_epoch == 3 and fresh.get_lr() == sched()
    assert fresh.state_dict()["step"] == 3


def test_lazy_mode_and_lr_ratio_change_nothing():
    """The reference accepts both and stores neither (``optimizer.py:
    273-337``): the same steps give the same bits."""
    rng = np.random.default_rng(9)
    gs = [torch.from_numpy(rng.standard_normal(12).astype(np.float32))
          for _ in range(3)]
    outs = []
    for kw in ({}, {"lazy_mode": True}):
        p = _param(1)
        opt = topt.Adam(learning_rate=0.01, parameters=[p], **kw)
        for g in gs:
            p.grad = g.clone()
            opt.step()
        outs.append(p.detach().clone())
    for kw in ({}, {"lr_ratio": lambda q: 0.1}):
        p = _param(1)
        opt = topt.AdamW(learning_rate=0.01, parameters=[p], **kw)
        for g in gs:
            p.grad = g.clone()
            opt.step()
        outs.append(p.detach().clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[3])
    assert not torch.equal(outs[0], outs[2])


def test_minimize_is_backward_then_step():
    p = _param(2, 4)
    opt = topt.SGD(learning_rate=0.5, parameters=[p])
    before = p.detach().clone()
    assert opt.minimize((p * torch.arange(4.0)).sum()) == ([], [])
    torch.testing.assert_close(p.detach(), before - 0.5 * torch.arange(4.0))

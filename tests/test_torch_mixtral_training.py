"""Mixtral's training path in the port against the JAX package's, on
the CPU: ``mixtral_tiny`` (2 layers, hidden 64, 4 experts of 128, top 2,
f32), the JAX model's weights copied into the port with
``models.bridge.load_jax_params``, at 2 x 128 tokens (two dispatch groups
of ``max_seq_len``) and 1 x 128 (one: the flat path). The routing of
every block equal, then the logits within 1e-5, the aux loss within 1e-6,
every gradient within 1e-4 of its largest, and 3 ``jit.train_step_fn`` +
AdamW steps' losses within 1e-5 of the reference's jitted train step with
the aux loss in the step (``bench.py``'s MoE step): through
``chip_smoke.moe_parity_run`` and ``moe_parity_compare``, the card phase
``moe_parity``'s run and comparison (its CPU rehearsal).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jt
from paddle_tpu.core.tensor import unwrap
from paddle_tpu.jit import functional_call
from paddle_tpu.jit import train_step_fn as jax_train_step_fn
from paddle_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from paddle_tpu.models.mixtral import mixtral_tiny as jax_mixtral_tiny
from paddle_tpu_torch.models import (MixtralForCausalLM, load_jax_params,
                                     mixtral_tiny)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


@functools.lru_cache(maxsize=1)
def _jax_model():
    jt.seed(31)
    jm = JaxMixtral(jax_mixtral_tiny())
    jm.eval()
    return jm


def _port_model():
    tm = MixtralForCausalLM(mixtral_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy()
                         for n, p in _jax_model().named_parameters()})
    return tm


def _jax_ce(logits, labels):
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    return -jnp.take_along_axis(logp, labels[:, 1:, None], -1).mean()


def _jax_run(jm, ids, steps=3, lr=1e-3):
    """The reference's side of ``chip_smoke.moe_parity_run``: the gates'
    probabilities and masks of an eager forward, logits, aux loss and
    gradients by ``jax.value_and_grad`` over ``functional_call``, and the
    jitted train step's losses with the aux loss in the step."""
    coef = jm.cfg.aux_loss_coef
    seen = []

    def hook(layer, inputs, out):
        logits = inputs[0].numpy() @ layer.gate.weight.numpy()
        seen.append((np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)),
                     _np(out.dispatch_mask)))

    hooks = [blk.moe.gate.register_forward_post_hook(hook)
             for blk in jm.model.layers]
    jm(jt.to_tensor(ids))
    for h in hooks:
        h.remove()
    x = jnp.asarray(ids)

    def loss_of(ps):
        logits = functional_call(jm, ps, x)
        aux = unwrap(jm.collect_aux_loss())
        return _jax_ce(logits, x) + coef * aux, (logits, aux)

    (loss, (logits, aux)), grads = jax.value_and_grad(
        loss_of, has_aux=True)(jm.raw_params())

    def step_loss(logits, labels):
        return _jax_ce(logits, labels) + coef * unwrap(
            jm.collect_aux_loss())

    jopt = jt.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters())
    jstep = jax_train_step_fn(jm, step_loss, jopt, donate=False)
    params = jm.raw_params()
    state = jopt.functional()[0](params)
    losses = []
    for i in range(steps):
        lv, params, state = jstep(params, state,
                                  {"inputs": (x,), "labels": (x,)}, i + 1)
        losses.append(float(lv))
    return {"logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "probs": [p for p, _ in seen],
            "masks": [m for _, m in seen],
            "grads": {n: np.asarray(g) for n, g in grads.items()},
            "losses": losses}


@pytest.mark.parametrize("batch", [2, 1], ids=["grouped", "flat"])
def test_mixtral_training_matches_jax(batch):
    ids = np.random.default_rng(batch).integers(0, 256, (batch, 128)) \
        .astype(np.int32)
    want = _jax_run(_jax_model(), ids)
    got = chip_smoke.moe_parity_run(torch, np, _port_model(),
                                    ids.astype(np.int64))
    checks, nums = chip_smoke.moe_parity_compare(np, got, want)
    assert nums["routing flips"] == 0, nums
    assert all(checks.values()), (checks, nums)
    assert len(checks) == 7
    assert got["losses"][2] < got["losses"][0]
    assert abs(got["loss"] - want["loss"]) <= 1e-5


def _compare_inputs(probs, B, S, C=4):
    """A yardstick ``moe_parity_run`` result around one block's gate
    ``probs`` ``[G, g, E]`` for ``B`` x ``S`` tokens: seeded logits, zero
    masks ``[G, g, E, C]``, one gradient, three losses."""
    rng = np.random.default_rng(0)
    return {"logits": rng.standard_normal((B, S, 5)), "aux": 0.5,
            "loss": 1.0, "probs": [probs],
            "masks": [np.zeros(probs.shape + (C,), bool)],
            "grads": {"w": rng.standard_normal(3)}, "losses": [1.0, 0.9, 0.8]}


def _swap(probs, token, a=0, b=1):
    """``probs`` with experts ``a`` and ``b`` swapped at the flat
    ``token``."""
    out = probs.copy()
    flat = out.reshape(-1, out.shape[-1])
    flat[token, [a, b]] = flat[token, [b, a]]
    return out


def test_moe_parity_compare_allows_only_near_ties():
    """A flipped routing decision passes only where the yardstick's
    probabilities tie within ``MOE_TIE``."""
    probs = np.array([[[0.5, 0.3, 0.2], [0.4, 0.4 - 1e-6, 0.2]]],
                     np.float32)
    want = _compare_inputs(probs, 1, 2)
    for token, ok in ((1, True), (0, False)):
        got = dict(want, probs=[_swap(probs, token)])
        checks, nums = chip_smoke.moe_parity_compare(np, got, want)
        assert nums["routing flips"] == 1
        assert checks["routing equal but at near-ties"] is ok


def test_moe_reach_follows_rows_and_groups():
    """A change reaches its row's later tokens and its group's."""
    hit = np.zeros(8, bool)
    hit[1] = True
    # rows of 2, groups of 4: token 1's row ends at 1, its group at 3
    assert chip_smoke.moe_reach(np, hit, 2, 4).tolist() == \
        [False, True, True, True, False, False, False, False]
    # rows of 4, groups of 2 (one group a half row)
    assert chip_smoke.moe_reach(np, hit, 4, 2).tolist() == \
        [False, True, True, True, False, False, False, False]
    hit[:] = False
    hit[6] = True
    assert chip_smoke.moe_reach(np, hit, 8, 8).tolist() == \
        [False] * 6 + [True, True]


def test_moe_parity_compare_keeps_the_value_checks_under_a_flip():
    """A near-tie flip leaves every value check in place: the logits and
    dispatch masks are held at the tokens the flip cannot reach, and the
    aux loss, gradients and losses, which every token reaches, fail."""
    B, S = 2, 4
    probs = np.tile(np.array([0.5, 0.3, 0.2], np.float32), (B, S, 1))
    probs[0, 2] = [0.4, 0.4 - 1e-6, 0.2]          # a near-tie at row 0, 2
    want = _compare_inputs(probs, B, S)
    got = dict(want, probs=[_swap(probs, 2)])
    # the flip's reach (row 0 from position 2) may differ as it likes
    got["logits"] = want["logits"].copy()
    got["logits"][0, 2:] += 1.0
    got["masks"] = [want["masks"][0].copy()]
    got["masks"][0][0, 3] = True
    checks, nums = chip_smoke.moe_parity_compare(np, got, want)
    assert len(checks) == 7
    assert nums["routing flips"] == nums["near-tie flips"] == 1
    assert nums["tokens no flip reaches"] == 6
    needs_equal = {k for k in checks if "needs equal routing" in k}
    assert len(needs_equal) == 3
    assert all(v for k, v in checks.items() if k not in needs_equal), checks
    assert not any(checks[k] for k in needs_equal)
    # what the flip cannot reach is still held
    bad = dict(got, logits=got["logits"].copy())
    bad["logits"][1, 0] += 1.0
    checks, _ = chip_smoke.moe_parity_compare(np, bad, want)
    assert not checks["logits within 1e-05 of the largest where no flip "
                      "reaches"]
    bad = dict(got, masks=[got["masks"][0].copy()])
    bad["masks"][0][1, 0, 0, 0] = True
    checks, _ = chip_smoke.moe_parity_compare(np, bad, want)
    assert not checks["dispatch masks equal where no flip reaches"]
    # a flip at every row's first token leaves no logits to compare
    probs[:, 0] = [0.4, 0.4 - 1e-6, 0.2]
    want = _compare_inputs(probs, B, S)
    got = dict(want, probs=[_swap(_swap(probs, 0), S)])
    checks, nums = chip_smoke.moe_parity_compare(np, got, want)
    assert nums["tokens no flip reaches"] == 0
    assert not checks["logits within 1e-05 of the largest where no flip "
                      "reaches"]


def test_mixtral_forward_and_loss_run_on_the_cpu_place():
    """``forward`` / ``loss`` run (they raised before item 13's single-card
    part), with the aux loss of the last forward in the loss."""
    tm = _port_model()
    ids = torch.zeros((1, 16), dtype=torch.long)
    logits = tm(ids)
    ce = torch.nn.functional.cross_entropy(logits[0, :-1], ids[0, 1:])
    aux = tm.collect_aux_loss()
    assert torch.allclose(tm.loss(logits, ids),
                          ce + tm.cfg.aux_loss_coef * aux, atol=1e-6)
    assert tm.cfg.active_params_ratio == 0.5

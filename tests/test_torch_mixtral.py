"""The port's Mixtral family against the JAX package's, on the CPU.

Weights are made once on the JAX side (``mixtral_tiny``: 2 layers,
hidden 64, 4 query heads over 2 kv heads of 16, 4 experts of 128, top
2, f32) and copied into the port with ``models.bridge.load_jax_params``;
the same numpy inputs go through both packages.

- the parameter names and shapes of the JAX model (the router ``moe.
  gate.gate.weight [H, E]``, the experts ``w_gate``/``w_up [E, H, F]``
  and ``w_down [E, F, H]``);
- ``_moe_topk_ffn`` against the reference's at top_k 1 and 2, f32
  within 1e-6 and bf16 within 2e-2 of the output's scale, with a
  constructed router tie (two equal router columns: both packages take
  the first maximum, then the other);
- the dense bundle: prefill and one decode step's logits within atol
  1e-5 of the JAX bundle's;
- ``generate`` tokens EQUAL to the JAX package's, greedy and seeded
  sampled;
- the paged server, split and fused ticks, greedy and seeded sampled,
  and an optimistic wave on an undersized pool (preemptions and
  replays): tokens, stats and pool balance equal to the JAX server's;
- ``forward`` and ``loss`` (the capacity dispatch of the training path)
  run and give the JAX model's logits and loss; the expert-parallel
  groups (the four-card part of ROADMAP Queue 1 item 13) raise, naming
  it. ``tests/test_torch_mixtral_training.py`` holds the training path
  to the reference in full.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from paddle_tpu.models.mixtral import mixtral_tiny as jax_mixtral_tiny
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.models import (MixtralForCausalLM, load_jax_params,
                                     mixtral_8x7b, mixtral_tiny)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops.kernels import fused_tick as tft
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_prefill as trp

V = 256
MCL, PG = 64, 8
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
              seed=2**31 - 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one torch thread each keeps the
    test workers (several a machine) from oversubscribing its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=1)
def _models():
    pt.seed(31)
    jm = JaxMixtral(jax_mixtral_tiny())
    jm.eval()
    tm = MixtralForCausalLM(mixtral_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


def _ids(B, T=9, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


def test_parameter_names_and_shapes_equal_the_jax_model():
    jm, tm = _models()
    want = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    assert got["model.layers.0.moe.gate.gate.weight"] == (64, 4)
    assert got["model.layers.1.moe.experts.w_down"] == (4, 128, 64)
    # Mixtral-8x7B's widths, which the card's smoke serves at 8 of its
    # 32 layers
    cfg = mixtral_8x7b(num_layers=8)
    assert (cfg.hidden_size, cfg.num_kv_heads, cfg.intermediate_size,
            cfg.num_experts, cfg.top_k) == (4096, 8, 14336, 8, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_topk_ffn_matches_jax_with_a_router_tie(top_k, dtype):
    rng = np.random.default_rng(top_k)
    b, s, H, E, F = 2, 5, 16, 4, 24
    h = rng.standard_normal((b, s, H)).astype(np.float32)
    router = rng.standard_normal((H, E)).astype(np.float32) * 0.1
    # experts 1 and 2 tie exactly, above the rest on every row with a
    # positive projection onto the shared column
    router[:, 2] = router[:, 1] = np.abs(h).mean((0, 1)) * 3.0
    h = np.abs(h)
    wg, wu = (rng.standard_normal((E, H, F)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((E, F, H)).astype(np.float32) * 0.2
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    want = np.asarray(jgen._moe_topk_ffn(
        *(jnp.asarray(a).astype(jd) for a in (h, router, wg, wu, wd)),
        top_k).astype(jnp.float32))
    got = tgen._moe_topk_ffn(
        *(torch.from_numpy(a).to(td) for a in (h, router, wg, wu, wd)),
        top_k).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the tie picks expert 1 first: the output is expert 1's alone at
    # top 1, experts 1 and 2 at equal gates at top 2
    th = torch.from_numpy(h).to(td)

    def expert(e):
        g, u = th @ torch.from_numpy(wg[e]).to(td), \
            th @ torch.from_numpy(wu[e]).to(td)
        return (torch.nn.functional.silu(g) * u) @ torch.from_numpy(
            wd[e]).to(td)

    probs = torch.softmax((th @ torch.from_numpy(router).to(td)).float(), -1)
    assert (probs.argmax(-1) == 1).all()
    ref = expert(1).float() * probs[..., 1:2] if top_k == 1 else \
        (expert(1).float() + expert(2).float()) * 0.5
    np.testing.assert_allclose(got, ref.numpy(), rtol=0,
                               atol=1e-5 if dtype == "float32"
                               else 2e-2 * np.abs(want).max())


def test_dense_bundle_prefill_and_decode_logits_match_jax():
    jm, tm = _models()
    jb, tb = jm._decode_bundle(32), tm._decode_bundle(32)
    ids = _ids(2, 9, seed=2)
    jl, jc = jm._run_prefill(jb, ids)
    tl, tc = tm._run_prefill(tb, ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    tok = np.array([7, 9], np.int32)
    t = np.array([9, 9], np.int32)
    jo, _ = jb[2](jb[1](jnp.asarray(tok), jnp.asarray(t)), jc,
                  jnp.asarray(t))
    to, _ = tb[2](tb[1](torch.from_numpy(tok), torch.from_numpy(t)), tc,
                  torch.from_numpy(t))
    np.testing.assert_allclose(tb[3](to).numpy(), np.asarray(jb[3](jo)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_generate_tokens_equal_jax(sample):
    jm, tm = _models()
    ids = _ids(2)
    kw = dict(do_sample=True, seed=11, temperature=0.9, top_k=40) \
        if sample else {}
    want = np.asarray(jm.generate(pt.to_tensor(ids), max_new_tokens=8,
                                  **kw).numpy())
    got = tm.generate(ids, max_new_tokens=8, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- servers


def _prompts(n=6, seed=3, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, (int(k),)).astype(np.int32)
            for k in rng.integers(lo, hi, (n,))]


def _serve(srv, prompts, budget):
    rids = [srv.submit(p, max_new_tokens=budget) for p in prompts]
    out = srv.run()
    return [out[r] for r in rids]


STATS = ("prefill_tokens", "prefix_hit_tokens", "prefix_auto_hits",
         "admissions", "preemptions", "preempt_resumed", "grow_pages")


def _pair(**kw):
    jm, tm = _models()
    kw = dict(dict(max_slots=4, max_cache_len=MCL, cache_backend="paged",
                   page_size=PG, prefill_tokens_per_tick=6, seed=5), **kw)
    return JaxServer(jm, **kw), ContinuousBatchingServer(tm, **kw)


def _check(js, ts, want, got):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert {k: ts.stats[k] for k in STATS} == {k: js.stats[k] for k in STATS}
    assert tuple(ts.pool_balance()) == tuple(js.pool_balance())
    assert ts.pool_balance()[1] == 0
    assert ts.stats["nonfinite_logit_rows"] == 0
    assert tpa.paged_attention.launches == 0
    assert trp.ragged_prefill_attention.launches == 0
    assert tft.fused_tick_attention.launches == 0


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mode", ["split", "fused"])
def test_paged_server_equals_jax(mode, sample):
    js, ts = _pair(serving_mode=mode, **(SAMPLE if sample else {}))
    prompts = _prompts()
    _check(js, ts, _serve(js, prompts, 8), _serve(ts, prompts, 8))
    if mode == "fused":
        assert ts.stats["fused_launches"] > 0


def test_optimistic_wave_on_an_undersized_pool_equals_jax():
    js, ts = _pair(num_pages=9, admission="optimistic")
    prompts = _prompts()
    want, got = _serve(js, prompts, 24), _serve(ts, prompts, 24)
    _check(js, ts, want, got)
    assert ts.stats["preemptions"] >= 1, "the pool never preempted"


def test_forward_and_loss_raise_naming_item_13():
    """Item 13's single-card part is ported: ``forward`` and ``loss`` give
    the JAX model's values (f32, within 1e-5); only the expert-parallel
    groups, its four-card part, still raise naming item 13."""
    from paddle_tpu.core.tensor import unwrap
    from paddle_tpu.jit import functional_call
    from paddle_tpu_torch.parallel.moe import MoELayer
    jm, tm = _models()
    ids = _ids(1, 32)
    logits = functional_call(jm, jm.raw_params(), jnp.asarray(ids))
    aux = float(unwrap(jm.collect_aux_loss()))
    with torch.no_grad():
        got = tm(ids)
        loss = tm.loss(got, ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=0,
                               atol=1e-5)
    lp = np.asarray(jax.nn.log_softmax(logits[:, :-1], -1))
    ce = -np.take_along_axis(lp, ids[:, 1:, None], -1).mean()
    assert abs(loss.item() - (ce + 0.01 * aux)) <= 1e-5
    with pytest.raises(NotImplementedError, match="item 13"):
        MoELayer(64, num_experts=4, d_hidden=128, moe_group=object())

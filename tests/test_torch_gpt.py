"""The port's GPT family against the JAX package's, on the CPU.

Weights are made once on the JAX side (``gpt2_tiny``: 2 layers, hidden
64, 4 heads of 16, 128 learned positions, f32) and copied into the port
with ``models.bridge.load_jax_params``; the same numpy inputs go through
both packages.

- ``nn.LayerNorm`` / ``F.layer_norm`` and ``F.gelu(approximate=True)``
  against the reference's functions (f32 within 1e-5 and 1e-6, bf16
  within 8 bf16 ulps of 1 and 2e-2), and ``Embedding``'s and
  ``LayerNorm``'s refused options;
- the eager ``forward`` (K4's plain version on the CPU) within atol
  1e-5 of the JAX model's logits, and the shifted loss within 1e-6;
- the bridge: the same parameter names as the JAX model, the tied table
  crossing as ``lm_head_weight`` only (not ``gpt.wte.weight``), both
  ways (the port's weights exported into a JAX model give its logits);
- ``generate`` tokens EQUAL to the JAX package's, greedy and seeded
  sampled, whole and chunked prefill (learned positions offset a
  chunk); a cache longer than the position table refused by both;
- the dense server and the paged server, split and fused ticks, greedy
  and seeded sampled, with ``max_cache_len`` equal to the position
  table (so idle slots' padded rows sit past it): tokens, stats and
  pool balance equal to the JAX server's, no kernel launch;
- positions past the table read zeros (``_learned_positions``), where a
  torch index would raise: an idle slot's ragged prefill rows and a
  dense idle slot's decode row leave the live logits equal to JAX's;
- the kernels' contract on the CPU: GPT's q (a view of the fused qkv
  product) reaches K1, K2 and K3 contiguous, as their CUDA launches
  require.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.models import (GPTForCausalLM, export_params,
                                     gpt2_tiny, load_jax_params)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import fused_tick as tft
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_prefill as trp
from paddle_tpu_torch.ops.kernels import sample_rows as tsr

V = 256
MCL, PG = 128, 8            # the cache spans gpt2_tiny's position table
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
              seed=2**31 - 4)
STATS = ("prefill_tokens", "prefix_hit_tokens", "prefix_auto_hits",
         "admissions")


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
    pt.seed(12)
    jm = JaxGPT(jax_gpt2_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt2_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


def _ids(B, T=9, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


# ------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_match_the_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 64)) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    want = np.asarray(JF.layer_norm.__wrapped__(
        jx, 64, jnp.asarray(w).astype(dtype), jnp.asarray(b).astype(dtype),
        1e-5).astype(jnp.float32))
    ln = tnn.LayerNorm(64, epsilon=1e-5, dtype=getattr(torch, dtype),
                       device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    got = ln(tx)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * 8
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               rtol=0, atol=tol)
    gw = np.asarray(JF.gelu.__wrapped__(jx, approximate=True).astype(
        jnp.float32))
    gg = TF.gelu(tx, approximate=True).float().numpy()
    np.testing.assert_allclose(gg, gw, rtol=0,
                               atol=1e-6 if dtype == "float32" else 2e-2)


def test_embedding_and_layer_norm_refuse_unported_options():
    """The options these layers once refused now work as the reference's:
    ``padding_idx`` zeroes its row and its output rows, ``sparse`` is
    accepted (dense gradient, as the reference), ``weight_attr`` names
    the table's initializer, and LayerNorm's ``weight_attr=False`` /
    ``bias_attr=False`` leave it without a scale / a shift. Under one
    seed the tables are the reference's (Normal: within 3 ulps)."""
    from paddle_tpu_torch import seed as tseed
    ids = np.array([[3, 0, 1], [0, 7, 2]], np.int32)
    for kw in ({"padding_idx": 0}, {"sparse": True}, {}):
        pt.seed(3)
        ref = pt.nn.Embedding(8, 4, **kw)
        tseed(3)
        got = tnn.Embedding(8, 4, device="cpu", **kw)
        np.testing.assert_allclose(got.weight.numpy(), ref.weight.numpy(),
                                   rtol=4e-7, atol=0)
        out = got(torch.from_numpy(ids))
        want = ref(pt.to_tensor(ids)).numpy()
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=4e-7,
                                   atol=0)
        out.sum().backward()
        if kw.get("padding_idx") == 0:
            assert not got.weight.grad[0].any()
            assert not got.weight[0].any()
    from paddle_tpu_torch.nn import initializer as TI
    e = tnn.Embedding(8, 4, weight_attr=TI.Constant(0.5), device="cpu")
    assert torch.equal(e.weight, torch.full((8, 4), 0.5))
    ln = tnn.LayerNorm(4, weight_attr=False, bias_attr=False, device="cpu")
    assert ln.weight is None and ln.bias is None
    assert list(ln.state_dict()) == []
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    want = np.asarray(JF.layer_norm.__wrapped__(jnp.asarray(x.numpy()), 4))
    np.testing.assert_allclose(ln(x).numpy(), want, rtol=0, atol=1e-6)
    assert [n for n, _ in tnn.LayerNorm(4, device="cpu").named_parameters()
            ] == ["weight", "bias"]


# -------------------------------------------------- the eager oracle


def test_forward_logits_and_loss_match_jax():
    jm, tm = _models()
    ids = _ids(2)
    jl = jm(pt.to_tensor(ids))
    tl = tm(ids)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl.numpy()),
                               rtol=0, atol=1e-5)
    want = float(jm.loss(jl, pt.to_tensor(ids)).numpy())
    got = float(tm.loss(tl, ids).detach())
    assert abs(got - want) < 1e-6
    assert tfa.flash_fwd.launches == 0          # the plain version


def test_bridge_crosses_the_tied_head_as_lm_head_weight_both_ways():
    jm, tm = _models()
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(n for n, _ in jm.named_parameters())
    assert "lm_head_weight" in names and "gpt.wte.weight" not in names
    assert tm.lm_head_weight is tm.gpt.wte.weight
    # the port's own weights, exported and loaded into a JAX model
    tm2 = GPTForCausalLM(gpt2_tiny(), device="cpu", seed=7)
    out = export_params(tm2)
    assert set(out) == set(names)
    pt.seed(99)
    jm2 = JaxGPT(jax_gpt2_tiny())
    jm2.eval()
    for n, p in jm2.named_parameters():
        p.set_value(out[n])
    assert np.array_equal(np.asarray(jm2.gpt.wte.weight.numpy()),
                          out["lm_head_weight"])
    ids = _ids(1, 7, seed=4)
    np.testing.assert_allclose(tm2(ids).detach().numpy(),
                               np.asarray(jm2(pt.to_tensor(ids)).numpy()),
                               rtol=0, atol=1e-5)


def test_unported_training_options_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="item 9"):
        GPTForCausalLM(gpt2_tiny(tensor_parallel=True), device="cpu")
    _, tm = _models()
    with pytest.raises(NotImplementedError, match="item 13"):
        tm.pipeline_decompose()


# ------------------------------------------------------------ generate


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_generate_tokens_equal_jax(sample):
    jm, tm = _models()
    ids = _ids(2)
    kw = dict(do_sample=True, seed=11, temperature=0.9, top_k=40) \
        if sample else {}
    want = np.asarray(jm.generate(pt.to_tensor(ids), max_new_tokens=8,
                                  **kw).numpy())
    got = tm.generate(ids, max_new_tokens=8, **kw)
    assert got.dtype == torch.int32 and got.shape == (2, 17)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_prefill_offsets_the_learned_positions():
    """The reference's ``test_chunked_prefill_gpt_positions``: chunked
    prefill equals the whole prompt's, and JAX's chunked run."""
    jm, tm = _models()
    ids = _ids(1, 5, seed=12)
    whole = tm.generate(ids, max_new_tokens=4, max_cache_len=32)
    chunked = tm.generate(ids, max_new_tokens=4, max_cache_len=32,
                          prefill_chunk=2)
    want = np.asarray(jm.generate(pt.to_tensor(ids), max_new_tokens=4,
                                  max_cache_len=32,
                                  prefill_chunk=2).numpy())
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    np.testing.assert_array_equal(chunked.numpy(), want)
    x = tm._prefill_embed(torch.from_numpy(ids[:, 2:4]), 2)
    want_x = tm.gpt.wte.weight[ids[:, 2:4]] + tm.gpt.wpe.weight[2:4]
    assert torch.equal(x, want_x)


def test_a_cache_past_the_position_table_is_refused_by_both():
    jm, tm = _models()
    with pytest.raises(ValueError, match="position table"):
        jm._decode_bundle(MCL + 8)
    with pytest.raises(ValueError, match="position table"):
        tm._decode_bundle(MCL + 8)


# -------------------------------------------------------------- servers


def _waves():
    rng = np.random.default_rng(3)
    wave1 = [rng.integers(0, V, (n,)).astype(np.int32)
             for n in (1, 7, 8, 13, 17)]
    wave2 = [np.concatenate([wave1[4][:16],
                             rng.integers(0, V, (n,)).astype(np.int32)])
             for n in (2, 5)]
    return wave1, wave2


def _serve(srv, n_new=6):
    toks = []
    for wave in _waves():
        rids = [srv.submit(p, max_new_tokens=n_new) for p in wave]
        out = srv.run()
        toks += [out[r] for r in rids]
    return toks


MODES = {"dense": dict(cache_backend="dense"),
         "split": dict(cache_backend="paged", page_size=PG,
                       prefill_tokens_per_tick=5),
         "fused": dict(cache_backend="paged", page_size=PG,
                       prefill_tokens_per_tick=5, serving_mode="fused")}


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mode", list(MODES))
def test_servers_equal_jax(mode, sample):
    jm, tm = _models()
    kw = dict(MODES[mode], **(SAMPLE if sample else {}))
    js = JaxServer(jm, max_slots=2, max_cache_len=MCL, **kw)
    ts = ContinuousBatchingServer(tm, max_slots=2, max_cache_len=MCL, **kw)
    want, got = _serve(js), _serve(ts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert {k: ts.stats[k] for k in STATS} == {k: js.stats[k] for k in STATS}
    bal = ts.pool_balance()
    assert (None if bal is None else tuple(bal)) == \
        (None if js.pool_balance() is None else tuple(js.pool_balance()))
    assert ts.stats["nonfinite_logit_rows"] == 0
    if mode != "dense":
        assert bal[1] == 0
    if mode == "fused":
        assert ts.stats["fused_launches"] > 0
    # CPU tensors take the plain versions: no kernel launch
    assert tpa.paged_attention.launches == 0
    assert trp.ragged_prefill_attention.launches == 0
    assert tft.fused_tick_attention.launches == 0
    assert tsr.sample_rows.launches == 0


# --------------------------------------------- positions past the table


def test_positions_past_the_table_read_zeros_and_leave_live_rows_alone():
    jm, tm = _models()
    wpe = tm.gpt.wpe.weight.detach()
    pos = torch.tensor([[0, 127], [128, 500]])
    rows = tgen._learned_positions(wpe, pos)
    assert torch.equal(rows[0, 0], wpe[0]) and torch.equal(rows[0, 1],
                                                            wpe[127])
    assert not rows[1].any()
    # a ragged prefill launch with an idle slot at the sentinel MCL: its
    # rows' positions run past the 128-row table
    jb = jm._decode_bundle(MCL, cache_backend="paged", page_size=PG,
                           num_pages=40)
    tb = tm._decode_bundle(MCL, cache_backend="paged", page_size=PG,
                           num_pages=40)
    tokens = _ids(3, 8, seed=5)
    t0 = np.array([0, MCL, 3], np.int32)
    out_idx = np.array([7, 0, 7], np.int32)
    bt = np.zeros((3, MCL // PG), np.int32)
    bt[0, :2], bt[2, :2] = [1, 2], [3, 4]
    jc, tc = jb[0](3), tb[0](3)
    jc = dict(jc, bt=jnp.asarray(bt))
    tc["bt"].copy_(torch.from_numpy(bt))
    jl, _ = jb[5](jnp.asarray(tokens), jnp.asarray(t0), jc,
                  jnp.asarray(out_idx))
    tl, _ = tb[5](torch.from_numpy(tokens), torch.from_numpy(t0), tc,
                  torch.from_numpy(out_idx))
    live = [0, 2]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=0, atol=1e-4)
    assert torch.isfinite(tl).all()
    # a dense decode step with one row past the table
    x = tb[1](torch.tensor([5, 9], dtype=torch.int32),
              torch.tensor([4, MCL + 6], dtype=torch.int32))
    assert x.shape == (2, 1, 64) and not (x[1, 0] - tm.gpt.wte.weight[9]).any()


def test_the_attention_kernels_get_a_contiguous_q(monkeypatch):
    """The CUDA wrappers refuse a strided q (``_check``); on the CPU the
    plain versions take any layout, so the contract is held here."""
    _, tm = _models()
    seen = []
    for name in ("paged_attention", "ragged_prefill_attention",
                 "fused_tick_attention"):
        def spy(q, *a, _f=getattr(tgen, name), _n=name, **k):
            seen.append((_n, q.is_contiguous()))
            return _f(q, *a, **k)
        monkeypatch.setattr(tgen, name, spy)
    for mode in ("split", "fused"):
        srv = ContinuousBatchingServer(tm, max_slots=2, max_cache_len=MCL,
                                       **MODES[mode])
        srv.submit(_ids(1, 11)[0], max_new_tokens=3)
        srv.run()
    assert {n for n, _ in seen} == {"paged_attention",
                                    "ragged_prefill_attention",
                                    "fused_tick_attention"}
    assert all(ok for _, ok in seen)

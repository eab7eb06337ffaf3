"""Quantized serving of the port against the JAX package's, on the CPU:
weight-only int8 (``weight_dtype="int8"``) for the three families on
both backends, and the dense int8 KV cache (``cache_dtype="int8"``).

- ``_quantize_tree``: int8 codes EQUAL to the reference's bit for bit
  (per layer and expert, per output channel; f32 and bf16 sources), f32
  scales within one f32 ulp; norms, the router and biases untouched;
- ``_mm`` / ``_emm`` with ``(int8, scale)`` pairs against the
  reference's, f32 within 4e-5 (sums of 32 products of outputs up to
  ~40) and bf16 within one bf16 ulp of the output's scale;
- ``generate(weight_dtype="int8")`` tokens EQUAL to the JAX package's on
  ``llama_tiny``, ``gpt2_tiny`` and ``mixtral_tiny``; the int8 prefill
  logits within the reference's rule of its float ones (max |diff|
  under 5% of max |logit|, ``tests/test_generation.py``); the int8
  bundle cached apart from the float one, its quantized copy shared by
  the model's int8 bundles: a byte a weight (a quarter of the f32
  projections' bytes) and an f32 scale a channel; quantized again
  after a load in place;
- int8 weights through the servers (Llama paged split, GPT paged fused,
  Mixtral dense): tokens equal to the JAX server's;
- ``_kv_write`` / ``_kv_read``: codes and scales EQUAL to the
  reference's jitted codec (a shared offset and per-row offsets, rows
  past the cache dropped), the read within 1e-6;
- the dense int8-cache server against the JAX server (GPT, as the
  reference's ``test_int8_kv_through_server_parity``, and Llama,
  greedy and sampled) and against ``generate(cache_dtype="int8")``;
- refused by both packages: ``cache_dtype="int8"`` on the paged
  backend, and a model converted by ``to_int8_inference``.
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
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from paddle_tpu.models.mixtral import mixtral_tiny as jax_mixtral_tiny
from paddle_tpu.quantization import to_int8_inference as jax_to_int8
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     MixtralForCausalLM, gpt2_tiny,
                                     llama_tiny, load_jax_params,
                                     mixtral_tiny)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.quantization import to_int8_inference

V = 256
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
              seed=2**31 - 4)
FAMILIES = {"llama": (JaxLlama, jax_llama_tiny, LlamaForCausalLM,
                      llama_tiny, 41),
            "gpt": (JaxGPT, jax_gpt2_tiny, GPTForCausalLM, gpt2_tiny, 42),
            "mixtral": (JaxMixtral, jax_mixtral_tiny, MixtralForCausalLM,
                        mixtral_tiny, 43)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one torch thread each keeps the
    test workers (several a machine) from oversubscribing its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _models(family):
    jcls, jcfg, tcls, tcfg, seed = FAMILIES[family]
    pt.seed(seed)
    jm = jcls(jcfg())
    jm.eval()
    tm = tcls(tcfg(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


def _ids(B, T=9, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


def _ulps(a, b):
    """|a - b| in f32 ulps of |b| (both f32 arrays)."""
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))


# ------------------------------------------------------ weight-only int8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tree_codes_equal_jax_scales_within_one_ulp(dtype):
    rng = np.random.default_rng(7)
    tree = {"wq": rng.standard_normal((3, 32, 48)),          # [L, K, N]
            "wg": rng.standard_normal((3, 4, 32, 40)),       # [L, E, K, F]
            "attn.qkv.weight": rng.standard_normal((3, 32, 96)) * 1e-3,
            "ln1": rng.standard_normal((3, 32)),
            "router": rng.standard_normal((3, 32, 4)),
            "mlp.fc1.bias": rng.standard_normal((3, 40))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    tree["wq"][1, :, 5] = 0.0                      # an all-zero channel
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jgen._quantize_tree({k: jnp.asarray(v).astype(jd)
                                for k, v in tree.items()})
    for k, v in tree.items():
        # the port quantizes a layer at a time: its weights are not stacked
        got = [tgen._quantize_tree({k: torch.from_numpy(v[i]).to(td)})[k]
               for i in range(v.shape[0])]
        if not isinstance(want[k], tuple):
            assert all(not isinstance(g, tuple) for g in got), k
            continue
        jq, js = (np.asarray(a) for a in want[k])
        tq = np.stack([g[0].numpy() for g in got])
        ts = np.stack([g[1].numpy() for g in got])
        assert tq.dtype == np.int8 and ts.dtype == np.float32, k
        assert tq.shape == jq.shape and ts.shape == js.shape, k
        np.testing.assert_array_equal(tq, jq, err_msg=k)
        assert _ulps(ts, js).max() <= 1.0, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_mm_and_emm_match_jax(dtype):
    rng = np.random.default_rng(8)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    we = rng.standard_normal((4, 32, 24)).astype(np.float32)
    jw = jgen._quantize_tree({"wq": jnp.asarray(w).astype(jd),
                              "wg": jnp.asarray(we).astype(jd)})
    tw = tgen._quantize_tree({"wq": torch.from_numpy(w).to(td),
                              "wg": torch.from_numpy(we).to(td)})
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    want = np.asarray(jgen._mm(jx, jw["wq"]).astype(jnp.float32))
    got = tgen._mm(tx, tw["wq"])
    assert got.dtype == td
    tol = 4e-5 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    want = np.asarray(jgen._emm("bsh,ehf->besf", jx, jw["wg"]).astype(
        jnp.float32))
    got = tgen._emm(tgen._expert_up, tx, tw["wg"]).float().numpy()
    tol = 4e-5 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the down projection: [b, E, s, F] through w_down [E, F, H]
    jy = jgen._emm("bsh,ehf->besf", jx, jw["wg"])
    ty = tgen._emm(tgen._expert_up, tx, tw["wg"])
    wd = rng.standard_normal((4, 24, 32)).astype(np.float32)
    jwd = jgen._quantize_tree({"wd": jnp.asarray(wd).astype(jd)})["wd"]
    twd = tgen._quantize_tree({"wd": torch.from_numpy(wd).to(td)})["wd"]
    want = np.asarray(jgen._emm("besf,efh->besh", jy, jwd).astype(
        jnp.float32))
    got = tgen._emm(tgen._expert_down, ty, twd).float().numpy()
    tol = 4e-4 if dtype == "float32" else 2 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generate_int8_tokens_equal_jax(family):
    jm, tm = _models(family)
    ids = _ids(2)
    want = np.asarray(jm.generate(pt.to_tensor(ids), max_new_tokens=8,
                                  weight_dtype="int8").numpy())
    got = tm.generate(ids, max_new_tokens=8, weight_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_int8_prefill_logits_within_the_references_rule(family):
    """``tests/test_generation.py``'s rule for int8 weights: the first
    token's logits within 5% of the float logits' largest magnitude."""
    _, tm = _models(family)
    ids = _ids(2, 5, seed=6)
    lf, _ = tm._run_prefill(tm._decode_bundle(64), ids)
    l8, _ = tm._run_prefill(tm._decode_bundle(64, "int8"), ids)
    rel = (l8 - lf).abs().max() / (lf.abs().max() + 1e-9)
    assert 0 < rel < 0.05


def test_int8_bundle_is_cached_apart_and_shares_one_quantized_copy():
    """The reference's ``test_int8_bundle_cached_separately`` (GPT: float
    tokens stable across an interleaved int8 call), and the port's own:
    one quantized copy for the model's int8 bundles, a byte a weight and
    an f32 scale a channel, holding no autograd graph, dropped by
    ``reset_generate_cache``."""
    _, tm = _models("gpt")
    tm.reset_generate_cache()
    ids = np.zeros((1, 3), np.int32)
    a = tm.generate(ids, max_new_tokens=3, max_cache_len=32)
    tm.generate(ids, max_new_tokens=3, weight_dtype="int8",
                max_cache_len=32)
    c = tm.generate(ids, max_new_tokens=3, max_cache_len=32)
    np.testing.assert_array_equal(a.numpy(), c.numpy())
    keys = {(k[0], k[1]) for k in tm._pt_decode_cache}
    assert keys == {(32, None), (32, "int8")}
    # as a server builds them: outside generate()'s no_grad
    tm.reset_generate_cache()
    assert torch.is_grad_enabled()
    dense = tm._decode_bundle(32, "int8")
    paged = tm._decode_bundle(32, "int8", cache_backend="paged",
                              page_size=8, num_pages=9)
    assert dense[2].weights is paged[2].weights
    q = dense[2].weights[0]["attn.qkv.weight"]
    assert q[0].dtype == torch.int8 and q[1].shape == (1, 192)
    assert tm._decode_bundle(32)[2].weights[0]["attn.qkv.weight"] is \
        tm.gpt.blocks[0].attn.qkv.weight
    pairs = [w for blk in dense[2].weights for w in blk.values()
             if isinstance(w, tuple)]
    # built without autograd: a scale with a graph would keep a
    # full-size |w| of its trainable weight alive
    assert not any(t.requires_grad or t.grad_fn for w in pairs for t in w)
    qbytes = sum(t.numel() * t.element_size() for w in pairs for t in w)
    fbytes = sum(p.numel() * p.element_size()
                 for blk in tm.gpt.blocks
                 for p in (blk.attn.qkv.weight, blk.attn.proj.weight,
                           blk.mlp.fc1.weight, blk.mlp.fc2.weight))
    assert qbytes == fbytes // 4 + 4 * 2 * (192 + 64 + 256 + 64)
    tm.reset_generate_cache()
    assert tm._pt_int8_blocks is None


def test_int8_bundles_follow_weights_loaded_in_place():
    """An int8 bundle quantizes the weights it is built from: after a
    load in place, the cached bundle and a new one (another cache
    length, while an old bundle still lives) serve the new weights'
    codes, as the reference's bundles built from the new weights do."""
    jm_a, _ = _models("llama")
    pt.seed(7)
    jm_b = JaxLlama(jax_llama_tiny())
    jm_b.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm_a.named_parameters()})
    ids = _ids(2, seed=3)
    kw = dict(max_new_tokens=8, weight_dtype="int8")
    want_a = np.asarray(jm_a.generate(pt.to_tensor(ids), **kw).numpy())
    want_b = np.asarray(jm_b.generate(pt.to_tensor(ids), **kw).numpy())
    assert not np.array_equal(want_a, want_b)
    np.testing.assert_array_equal(
        tm.generate(ids, max_cache_len=32, **kw).numpy(), want_a)
    old = tm._decode_bundle(24, "int8")
    load_jax_params(tm, {n: p.numpy() for n, p in jm_b.named_parameters()})
    assert old[2].weights.stale()
    np.testing.assert_array_equal(
        tm.generate(ids, max_cache_len=32, **kw).numpy(), want_b)
    new = tm._decode_bundle(40, "int8")
    assert new[2].weights is not old[2].weights
    np.testing.assert_array_equal(
        tm.generate(ids, max_cache_len=40, **kw).numpy(), want_b)
    # unchanged weights: the live bundles share one copy
    assert tm._decode_bundle(32, "int8")[2].weights is new[2].weights


@pytest.mark.parametrize("family,mode", [
    ("llama", "split"), ("gpt", "fused"), ("mixtral", "dense")])
def test_int8_weight_servers_equal_jax(family, mode):
    jm, tm = _models(family)
    kw = dict(max_slots=2, max_cache_len=64, weight_dtype="int8",
              prefill_tokens_per_tick=5)
    if mode == "dense":
        kw.update(cache_backend="dense")
    else:
        kw.update(cache_backend="paged", page_size=8, serving_mode=mode)
    js = JaxServer(jm, **kw)
    ts = ContinuousBatchingServer(tm, **kw)
    prompts = [_ids(1, n, seed=n)[0] for n in (3, 9, 14)]
    for srv in (js, ts):
        rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
        out = srv.run()
        srv._out = [out[r] for r in rids]
    for a, b in zip(ts._out, js._out):
        np.testing.assert_array_equal(a, b)
    assert ts.stats["nonfinite_logit_rows"] == 0


# ------------------------------------------------- the dense int8 cache


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "rows"])
def test_kv_write_and_read_equal_the_jitted_reference(per_row):
    rng = np.random.default_rng(9)
    B, T, h, hd, s = 3, 10, 2, 8, 1 if per_row else 3
    kv = (rng.standard_normal((B, s, h, hd)) * 3).astype(np.float32)
    kv[0, 0, 1] = 0.0                              # an all-zero row
    t = np.array([2, T - 1, T + 4], np.int32) if per_row else np.int32(4)
    shape = (B, T, h, hd)
    jlc = jgen._init_kv(shape, jnp.float32, "int8")
    tlc = tgen._init_kv(shape, torch.float32, "int8", "cpu")
    assert set(tlc) == {"k", "v", "ks", "vs"}
    assert tlc["k"].dtype == torch.int8 and tlc["ks"].shape == shape[:-1]
    write = jax.jit(lambda lc, x, t: jgen._kv_write(lc, "k", x, t))
    jlc = write(jlc, jnp.asarray(kv), jnp.asarray(t))
    tgen._kv_write(tlc, "k", torch.from_numpy(kv),
                   torch.from_numpy(t) if per_row else int(t))
    np.testing.assert_array_equal(tlc["k"].numpy(), np.asarray(jlc["k"]))
    np.testing.assert_array_equal(tlc["ks"].numpy(), np.asarray(jlc["ks"]))
    assert tlc["k"].abs().max() == 127
    want = np.asarray(jgen._kv_read(jlc, "k", jnp.float32))
    got = tgen._kv_read(tlc, "k", torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 4] if not per_row else got[0, 2],
                               kv[:, 0] if not per_row else kv[0, 0],
                               rtol=0, atol=3 * 3 * 4 / 127)


@pytest.mark.parametrize("family,sample", [
    ("gpt", False), ("llama", False), ("llama", True)])
def test_dense_int8_cache_server_equals_jax(family, sample):
    jm, tm = _models(family)
    kw = dict(max_slots=2, max_cache_len=32, cache_dtype="int8",
              **(SAMPLE if sample else {}))
    js, ts = JaxServer(jm, **kw), ContinuousBatchingServer(tm, **kw)
    assert ts._caches["k"].dtype == torch.int8 and "ks" in ts._caches
    prompts = [_ids(1, n, seed=20 + n)[0] for n in (5, 2, 11)]
    for srv in (js, ts):
        rids = [srv.submit(p, max_new_tokens=4) for p in prompts]
        out = srv.run()
        srv._out = [out[r] for r in rids]
    for a, b in zip(ts._out, js._out):
        np.testing.assert_array_equal(a, b)
    if not sample:      # the reference's server-against-generate check
        want = tm.generate(prompts[0][None], max_new_tokens=4,
                           max_cache_len=32, cache_dtype="int8").numpy()
        np.testing.assert_array_equal(ts._out[0], want[0, 5:])


# ------------------------------------------------------------- refusals


def test_paged_int8_cache_is_refused_by_both_packages():
    jm, tm = _models("llama")
    kw = dict(cache_dtype="int8", cache_backend="paged", page_size=8,
              num_pages=9)
    with pytest.raises(NotImplementedError, match="paged backend"):
        jm._decode_bundle(32, **kw)
    with pytest.raises(NotImplementedError, match="paged backend"):
        tm._decode_bundle(32, **kw)
    with pytest.raises(NotImplementedError, match="paged backend"):
        ContinuousBatchingServer(tm, max_slots=2, max_cache_len=32,
                                 cache_backend="paged", page_size=8,
                                 cache_dtype="int8")


def test_a_converted_model_is_refused_by_both_packages():
    """The reference's bundle reads trainable parameters (``lm_head.
    weight``, then ``raw_params()``), and its ``Int8InferLinear`` keeps
    the weight as buffers: reading it fails. The port refuses before it
    reads any, saying so."""
    jm, tm = _models("llama")
    with pytest.raises(AttributeError, match="weight"):
        jax_to_int8(jm)._decode_bundle(32)
    with pytest.raises(NotImplementedError, match="as in the reference"):
        to_int8_inference(tm)._decode_bundle(32)

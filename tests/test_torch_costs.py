"""The port's cost catalog and its analytic price model.

The JAX package prices each serving program with XLA's
``lower().compile().cost_analysis()``; its ``tests/test_costs.py``
asserts the compiler's FLOP counts, AOT caching, the fallback for a
function it cannot lower, and the skipped-DMA cross-validation against
compiled bytes. The port has no compiler to ask: its programs are eager
calls into hand-written kernels, priced by ``models.costs`` from the
model's config. So those cases are replaced here by:

- the analytic model against a hand count at ``llama_tiny`` shapes (the
  dense terms and each attention kernel's, then a decode step, a ragged
  prefill launch, a fused tick of one pass and of two composed of
  them), at ``gpt2_tiny``'s and ``mixtral_tiny``'s, and with int8
  weights (a byte a weight, an f32 scale a channel), and ``chip_smoke.py``'s bounds for K1, K2 and K3 built from
  the same attention model at the main path's shapes;
- the catalog's surface with explicit prices: the per-op warm-up and
  recompile watch, the fallback for an unpriced function (counted in
  ``price_errors``, never a compile), a first call's kernel build
  joining its compile time, phases, MFU on a FakeClock, the published
  metrics, and the disabled catalog (no clock read, no lock, the server
  treats it as None);
- the catalog on the server (``llama_tiny`` on the CPU): every launch
  charged the model's price for its shapes, tokens unchanged, a new
  chunk width after warm-up landing as a recorder event and a
  ``compile_stall`` journey phase, phases in the tick events, and the
  snapshot in ``/stats``, postmortems and ``utilization()``.
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu.telemetry as JT
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     MixtralForCausalLM, gpt2_tiny,
                                     llama_tiny, mixtral_tiny)
from paddle_tpu_torch.models.costs import (GPTServingCosts,
                                           LlamaServingCosts,
                                           MixtralServingCosts,
                                           serving_costs)
from paddle_tpu_torch.telemetry import (CostCatalog, FakeClock,
                                        FlightRecorder, MetricRegistry,
                                        ServerTelemetry)
import paddle_tpu_torch.telemetry.costs as costs_mod
from paddle_tpu_torch.telemetry.costs import (COMPILE_BUCKETS,
                                              PHASE_BUCKETS, TICK_PHASES)
from test_torch_preemption import TorchStub


class _CountingLock:
    def __init__(self):
        self.acquisitions = 0

    def __enter__(self):
        self.acquisitions += 1
        return self

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------- the price model

CFG = llama_tiny()        # 2 layers, H 64, 4 heads of 16, 2 kv heads, I 128


def _tiny(slots=4, pages=8, pg=8, e=4):
    return LlamaServingCosts(CFG, e, e, pg, pages, slots)


def test_dense_terms_equal_a_hand_count():
    """Projections and MLP as 2 M N K over the rows, each weight read once
    a launch, embedding rows and K/V writes a row, the head a slot."""
    m = _tiny()
    H, q, kv, I, V, L = 64, 64, 32, 128, 256, 2
    per_row = 2 * (H * q + H * kv + H * kv + q * H + H * I + H * I + I * H)
    assert m.row_flops == per_row
    weights = L * (H * q + 2 * H * kv + q * H + 3 * H * I + 2 * H) + H
    rows = 12
    f, b = m.dense(rows, 4)
    assert f == L * rows * per_row + 2 * 4 * H * V
    assert b == 4 * (weights + H * V + rows * H + 4 * V) \
        + rows * 2 * L * kv * 4
    f0, b0 = m.dense(rows, 0)
    assert f0 == L * rows * per_row
    assert b0 == 4 * (weights + rows * H) + rows * 2 * L * kv * 4
    assert m.row_nbytes == 2 * L * kv * 4


def test_attention_terms_equal_a_hand_count():
    """K1, K2 and K3 of one layer at ``llama_tiny``'s heads (4 of 16 over
    2 kv heads), 8-token pages, an 8-page table, f32: each FLOP and byte
    counted by hand."""
    a = _tiny().attn
    # K1: keys 5, 0, 9 -> 14 keys, pages 1 + 0 + 2
    assert a.k1([5, 0, 9]) == (4 * 14 * 4 * 16,
                               2 * 3 * 64 * 4 + 2 * 14 * 32 * 4 + 3 * 4
                               + 3 * 4)
    # K2, C = 4: rows 0..2 see 1, 2, 3 keys; rows 6..9 see 7 .. 10; the
    # slot at t0 = T is idle. 7 rows, 40 visible keys, 3 + 10 keys read
    # over 1 + 2 pages
    assert a.k2([(0, 3), (64, 0), (6, 4)], 4) == (
        4 * 40 * 64,
        7 * 64 * 4 + 3 * 4 * 64 * 4 + 2 * 13 * 32 * 4 + 12 * 3 + 3 * 4)
    # K3, C = 8: a decode row at 9 (10 keys, pages 0 and 1), rows 3..7
    # (4 .. 8 keys, page 0), an idle slot: 6 rows, 40 keys, 3 pages
    slots = [(9, 1, 1), (0, 0, 0), (3, 5, 0)]
    assert a.k3_pages(slots) == 3
    assert a.k3(slots, 8) == (
        4 * 40 * 64,
        6 * 64 * 4 + 3 * 8 * 64 * 4 + 2 * 3 * 8 * 32 * 4 + 4 * (9 + 6))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_attention_terms_equal_chip_smokes_bounds():
    """``chip_smoke.py`` bounds K1, K2 and K3 by the price model the
    server charges: at the main path's tensors (Llama-2-7B's heads, 8
    slots, 128 pages of 16, bf16) it builds the same ``AttentionCosts``
    as the 7B server's catalog, and at its K3 ticks the model lists the
    pages the kernel's schedule lists."""
    from paddle_tpu_torch.models import llama2_7b
    from paddle_tpu_torch.ops.kernels.fused_tick import build_schedule
    cs = _chip_smoke()
    m = LlamaServingCosts(llama2_7b(), 2, 2, 16, 128, 8)
    meta = functools.partial(torch.empty, device="meta",
                             dtype=torch.bfloat16)
    kp, bt = meta(1025, 16, 32, 128), torch.empty(8, 128, device="meta")
    for q in (meta(8, 32, 128), meta(8, 512, 32, 128)):      # K1; K2, K3
        assert vars(cs.attn_costs(q, kp, bt)) == vars(m.attn)
    for _, _, slots in cs.k3_ticks(128 * 16):
        last = [t + n - 1 if n else -1 for t, n, _ in slots]
        assert m.attn.k3_pages(slots) == build_schedule(last, 16,
                                                        n_slots=8)[2]


def test_launch_prices_compose_the_terms():
    """A decode call of n steps, a ragged prefill launch and a fused call
    of one and two passes, each the sum of its terms over every layer."""
    m = _tiny()
    t = [3, 9, 64, 70]                 # keys t + 1, clamped to 64
    f, b = m.decode(t, steps=2)
    fd, bd = m.dense(4, 4)
    k0, k1 = m.attn.k1([x + 1 for x in t]), m.attn.k1([x + 2 for x in t])
    assert (f, b) == (2 * fd + 2 * (k0[0] + k1[0]),
                      2 * bd + 2 * (k0[1] + k1[1]))
    slots = [(0, 8), (64, 0), (5, 8), (64, 0)]
    fd, bd = m.dense(4 * 8, 4)
    fa, ba = m.attn.k2(slots, 8)
    assert m.prefill(slots, 8) == (fd + 2 * fa, bd + 2 * ba)
    dec = [(9, 1, 1), (0, 0, 0), (0, 0, 0), (20, 1, 1)]
    pre = [(0, 0, 0), (0, 6, 0), (3, 5, 0), (0, 0, 0)]
    head = (2 * 4 * 64 * 256, 4 * 64 * 256 + 4 * 256 * 4)
    for passes in ([(dec, 1)], [(dec, 1), (pre, 8)]):
        f = head[0] + sum(m.dense(4 * C, 0)[0] + 2 * m.attn.k3(s, C)[0]
                          for s, C in passes)
        b = head[1] + sum(m.dense(4 * C, 0)[1] + 2 * m.attn.k3(s, C)[1]
                          for s, C in passes)
        assert m.fused(passes) == (f, b)


def test_serving_costs_prices_llama_only():
    """The model knows the port's three families (Llama, Mixtral, GPT:
    each its own price model, int8 weights when the bundle quantizes);
    any other model (the test stub) gets None, and its calls are priced
    as errors."""
    tm = LlamaForCausalLM(CFG, device="cpu")
    m = serving_costs(tm, 4, 8, 8, 2)
    assert isinstance(m, LlamaServingCosts) and m.W == 8 and m.S == 2
    assert serving_costs(TorchStub(), 4, 8, 8, 2) is None
    gm = serving_costs(GPTForCausalLM(gpt2_tiny(), device="cpu"), 4, 8, 8,
                       2, weight_dtype="int8")
    assert isinstance(gm, GPTServingCosts)
    assert gm.body_nbytes == GPTServingCosts(gpt2_tiny(), 4, 4, 8, 8, 2,
                                             int8_weights=True).body_nbytes
    mm = serving_costs(MixtralForCausalLM(mixtral_tiny(), device="cpu"), 4,
                       8, 8, 2)
    assert isinstance(mm, MixtralServingCosts)


def test_gpt_and_mixtral_terms_equal_a_hand_count():
    """GPT (``gpt2_tiny``: H 64, 4 heads of 16, I 256, 2 layers): qkv 3H^2,
    proj H^2, fc1 and fc2 4H^2 each a row, their biases, two LayerNorms
    (scale and shift) a layer, the final LayerNorm, token and position
    rows, MHA caches, the tied table as the head. Mixtral
    (``mixtral_tiny``: H 64, 4 heads over 2 kv heads, E 4 experts of I
    128): the Llama attention, the router H x E and all E experts' gate,
    up and down a row."""
    g = GPTServingCosts(gpt2_tiny(), 4, 4, 8, 8, 2)
    H, I, V, L = 64, 256, 256, 2
    per_row = 2 * (3 * H * H + H * H + H * I + I * H)
    assert g.row_flops == per_row
    layer = 3 * H * H + H * H + H * I + I * H + (3 * H + H + I + H) + 4 * H
    assert g.layer_params == layer
    f, b = g.dense(5, 2)
    assert f == L * 5 * per_row + 2 * 2 * H * V
    assert b == 4 * (L * layer + 2 * H + H * V + 5 * 2 * H + 2 * V) \
        + 5 * 2 * L * H * 4
    assert (g.attn.nh, g.attn.kvh, g.attn.hd) == (4, 4, 16)
    m = MixtralServingCosts(mixtral_tiny(), 4, 4, 8, 8, 2)
    H, I, E, q, kv = 64, 128, 4, 64, 32
    mats = H * q + 2 * H * kv + q * H + E * 3 * H * I
    assert m.row_flops == 2 * (mats + H * E)
    assert m.layer_params == mats + H * E + 2 * H
    f, b = m.dense(3, 0)
    assert f == L * 3 * 2 * (mats + H * E)
    assert b == 4 * (L * (mats + H * E + 2 * H) + H + 3 * H) \
        + 3 * 2 * L * kv * 4


def test_int8_weights_are_a_byte_a_weight_and_a_scale_a_channel():
    """The int8 bundle's bytes: every quantized matrix a byte a weight
    plus an f32 scale a copy (layer, expert) and output channel; norms,
    biases, the router, the embedding and the head at the model's
    element size. FLOPs do not change."""
    H, I, L = 64, 128, 2
    q, kv = 64, 32
    f32, i8 = _tiny(), LlamaServingCosts(CFG, 4, 4, 8, 8, 4,
                                         int8_weights=True)
    mats = H * q + 2 * H * kv + q * H + 3 * H * I
    chans = q + 2 * kv + H + 2 * I + H
    assert i8.row_flops == f32.row_flops
    assert i8.body_nbytes == L * (mats + 4 * chans + 4 * 2 * H) + 4 * H
    assert i8.head_nbytes == f32.head_nbytes
    m = MixtralServingCosts(mixtral_tiny(), 2, 2, 8, 8, 2,
                            int8_weights=True)
    E = 4
    mats = H * q + 2 * H * kv + q * H + E * 3 * H * I
    chans = q + 2 * kv + H + E * (2 * I + H)
    assert m.body_nbytes == L * (mats + 4 * chans + 2 * (H * E + 2 * H)) \
        + 2 * H
    g = GPTServingCosts(gpt2_tiny(), 2, 2, 8, 8, 2, int8_weights=True)
    H, I = 64, 256
    mats = 4 * H * H + 2 * H * I
    chans = 3 * H + H + I + H
    vec = (3 * H + H + I + H) + 4 * H
    assert g.body_nbytes == L * (mats + 4 * chans + 2 * vec) + 2 * 2 * H


# ------------------------------------------------------------- catalog

def test_catalog_keeps_the_references_surface():
    """The same constants and the same snapshot keys as the reference's
    catalog."""
    assert TICK_PHASES == JT.costs.TICK_PHASES
    assert PHASE_BUCKETS == JT.costs.PHASE_BUCKETS
    assert COMPILE_BUCKETS == JT.costs.COMPILE_BUCKETS
    assert set(CostCatalog().snapshot()) == set(JT.CostCatalog().snapshot())


def test_program_charges_its_price_and_caches_the_signature(monkeypatch):
    """A priced call dispatches and charges; repeats of a signature are a
    dict hit whose price is this dispatch's; the compile is recorded at
    the first call, with the first call's kernel build in its seconds."""
    reg = MetricRegistry()
    built = [0.0]

    def fn(x, caches):
        built[0] += 2.0               # this call "built" kernels for 2 s
        return x + 1

    monkeypatch.setattr(costs_mod, "_build_seconds", lambda: built[0])
    cat = CostCatalog(registry=reg)
    x, caches = torch.ones(4), {"k": torch.zeros(2, 3), "bt": torch.zeros(2)}
    prog = cat.program("decode", fn, (x, caches), price=(100.0, 40.0))
    assert prog.compiled_now and not prog.recompile
    assert cat.compiles() == {}                # recorded at the call
    assert torch.equal(prog(x, caches), x + 1)
    assert cat.compiles() == {"decode": 1}
    assert prog.compile_s == pytest.approx(2.0, abs=0.5)
    again = cat.program("decode", fn, (x, caches), price=lambda: (7, 3))
    assert again is prog and not again.compiled_now
    again(x, caches)
    other = cat.program("decode", fn, (torch.ones(8), caches), (1, 1))
    assert other.compiled_now and other is not prog
    cat.flush_tick()
    assert cat.totals() == {"decode": {"flops": 107.0, "hbm_bytes": 43.0,
                                       "dispatches": 2}}
    assert reg.get("server_flops_total").labels(op="decode").value == 107
    assert reg.get("server_compiles_total").labels(op="decode").value == 1
    assert reg.get("serving_compile_seconds").count == 1


def test_unpriced_function_is_an_error_not_a_compile():
    """``price=None`` (a model the port cannot price) keeps a zero-cost
    entry and bumps ``price_errors`` once; it never feeds the compile
    watch, before or after warm-up."""
    cat = CostCatalog(warm_after_ticks=1)
    x = torch.ones(2)
    prog = cat.program("decode", lambda a: a * 2, (x,))
    assert not prog.compiled_now and not prog.recompile
    prog(x)
    cat.flush_tick()
    assert cat.price_errors == 1 and cat.compiles() == {}
    assert cat.totals()["decode"] == {"flops": 0.0, "hbm_bytes": 0.0,
                                      "dispatches": 1}
    late = cat.program("decode", lambda a: a, (torch.ones(5),))
    assert not late.recompile and cat.recompiles == 0


def test_warmup_is_per_op_and_a_late_signature_is_a_recompile():
    """Each op warms after ``warm_after_ticks`` charged ticks without a
    compile of its own; another op's ladder neither arms nor trips it; a
    new signature of a warmed op is a recompile."""
    cat = CostCatalog(warm_after_ticks=2)
    fn = lambda a: a + 1                             # noqa: E731
    x = torch.ones(4)

    def tick(op, t, compiled):
        p = cat.program(op, fn, (t,), (1.0, 1.0))
        assert p.compiled_now == compiled
        p(t)
        cat.flush_tick()
        return p

    tick("decode", x, True)
    assert not cat.warmed
    tick("decode", x, False)
    tick("decode", x, False)
    assert cat.warmed_op("decode") and cat.warmed
    p = tick("fused", torch.ones(8), True)
    assert not p.recompile and not cat.warmed       # fused still climbing
    p = tick("fused", torch.ones(16), True)
    assert not p.recompile and cat.recompiles == 0
    tick("fused", torch.ones(16), False)
    tick("fused", torch.ones(16), False)
    assert sorted(cat.snapshot()["warm_ops"]) == ["decode", "fused"]
    p = cat.program("fused", fn, (torch.ones(32),), (1, 1))
    assert p.recompile
    p(torch.ones(32))
    assert cat.recompiles == 1
    assert not cat.program("decode", fn, (x,), (1, 1)).compiled_now


def test_phases_mfu_and_roofline_on_a_fake_clock():
    """``phase_timer`` splits a tick's wall; MFU is the tick's FLOPs over
    its wall over the peak, the roofline ratio the larger of the FLOP and
    byte shares; token_callbacks time carries over an idle flush."""
    fc = FakeClock()
    reg = MetricRegistry()
    cat = CostCatalog(registry=reg, clock=fc, peak_flops=1000.0,
                      peak_hbm_bytes_per_s=100.0)
    x = torch.ones(2)
    tp = cat.phase_timer()
    fc.advance(0.25)
    tp.mark("admission")
    cat.program("decode", lambda a: a, (x,), (128.0, 30.0))(x)
    fc.advance(0.25)
    tp.mark("decode_launch")
    tp.close("bookkeeping")
    cat.flush_tick()
    assert cat.mfu() == pytest.approx(128 / 0.5 / 1000)
    snap = cat.snapshot()
    assert snap["roofline_ratio"] == pytest.approx(30 / 0.5 / 100)
    assert snap["last_tick_phases"] == {"admission": 0.25,
                                        "decode_launch": 0.25}
    assert reg.get("serving_mfu").value == pytest.approx(cat.mfu())
    cat.add_phase("token_callbacks", 0.125)
    assert cat.flush_tick() is None                 # idle: carried over
    assert cat.pending_phases() == {"token_callbacks": 0.125}
    cat.charge_bytes("block_table", 64)
    cat.flush_tick()
    assert cat.snapshot()["last_tick_phases"] == {"token_callbacks": 0.125}
    assert cat.totals()["block_table"] == {"flops": 0.0, "hbm_bytes": 64.0,
                                           "dispatches": 1}
    for bad in ({"peak_flops": 0}, {"peak_hbm_bytes_per_s": -1}):
        with pytest.raises(ValueError):
            CostCatalog(**bad)


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_disabled_catalog_reads_no_clock_and_takes_no_lock(mode):
    """A disabled catalog is the identity on ``program``; the server
    treats it as None: no phase timer, no clock read, no lock."""
    fc = FakeClock()
    cat = CostCatalog(enabled=False, clock=fc)
    lock = _CountingLock()
    cat._lock = lock
    fn = lambda a: a                                 # noqa: E731
    assert cat.program("decode", fn, (torch.ones(2),)) is fn
    srv = ContinuousBatchingServer(TorchStub(), max_slots=2,
                                   max_cache_len=16, cache_backend="paged",
                                   page_size=4, serving_mode=mode,
                                   costs=cat)
    assert srv._costs is None and srv._price is None
    rid = srv.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=4)
    assert len(srv.run()[rid]) == 4
    assert fc.reads == 0 and lock.acquisitions == 0
    assert cat._tick == {} and cat._phases == {}
    assert srv.device_costs() is None and srv.utilization() == {}


# ------------------------------------------------------ on the server

@functools.lru_cache(maxsize=1)
def _model():
    torch.manual_seed(0)
    return LlamaForCausalLM(CFG, device="cpu", seed=3)


def _prompts(n=3, seed=5, lo=5, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(k),)).astype(np.int32)
            for k in rng.integers(lo, hi, n)]


def _server(**kw):
    kw = dict(dict(max_slots=4, max_cache_len=64, cache_backend="paged",
                   page_size=8, prefill_tokens_per_tick=16), **kw)
    return ContinuousBatchingServer(_model(), **kw)


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_every_launch_is_charged_the_models_price(mode):
    """On ``llama_tiny``: each prefill, decode and fused dispatch is
    charged exactly the model's price for its shapes (recomputed here
    from the arguments the bundle entries received), the tokens are those
    of a server without a catalog, and no call is priced as an error."""
    prompts = _prompts()
    plain = _server(serving_mode=mode)
    rids = [plain.submit(p, max_new_tokens=5) for p in prompts]
    out0 = plain.run()
    cat = CostCatalog()
    srv = _server(serving_mode=mode, costs=cat)
    m = srv._price
    expect = {"flops": 0, "hbm_bytes": 0}
    ragged, step, fused = srv._ragged_fn, srv._step_fn, srv._fused_fn

    def add(price):
        expect["flops"] += price[0]
        expect["hbm_bytes"] += price[1]

    def ragged_w(tokens, t0, *a):
        C = tokens.shape[1]
        add(m.prefill([(int(t), C if int(t) < 64 else 0) for t in t0], C))
        return ragged(tokens, t0, *a)

    def fused_w(tokens, t0, last, dec, *a):
        C, sl = tokens.shape[1], []
        for t, l, d in zip(t0.tolist(), last.tolist(), dec.tolist()):
            sl.append((t, 0, 0) if l < 0 else
                      (t, 1, 1) if d else (t, l - t + 1, 0))
        if C > 1 and any(s[2] for s in sl):
            passes = [([s if s[2] else (0, 0, 0) for s in sl], 1),
                      ([(0, 0, 0) if s[2] else s for s in sl], C)]
        else:
            passes = [(sl, C)]
        add(m.fused(passes))
        return fused(tokens, t0, last, dec, *a)

    def step_w(x, caches, t):
        add((m.dense(4, 4)[0] + 2 * m.attn.k1((t + 1).tolist())[0],
             m.dense(4, 4)[1] + 2 * m.attn.k1((t + 1).tolist())[1]))
        return step(x, caches, t)

    srv._ragged_fn, srv._step_fn, srv._fused_fn = ragged_w, step_w, fused_w
    rids2 = [srv.submit(p, max_new_tokens=5) for p in prompts]
    out = srv.run()
    for a, b in zip(rids, rids2):
        np.testing.assert_array_equal(out[b], out0[a])
    tot = cat.totals()
    ops = ("prefill", "decode") if mode == "split" else ("fused",)
    assert sum(tot[o]["flops"] for o in ops) == expect["flops"]
    assert sum(tot[o]["hbm_bytes"] for o in ops) == expect["hbm_bytes"]
    assert cat.price_errors == 0 and all(tot[o]["dispatches"] for o in ops)


def test_a_new_chunk_width_after_warmup_is_a_recompile_with_a_stall():
    """Short prompts warm the prefill ladder; a longer one needs a wider
    chunk: a recompile after warm-up, landing as a ``compile`` recorder
    event flagged ``recompile`` and a ``compile_stall`` phase in the
    journey of the request behind it."""
    rec = FlightRecorder()
    cat = CostCatalog()
    srv = _server(costs=cat, recorder=rec, journeys=True,
                  prefill_tokens_per_tick=64)
    for _ in range(2):
        srv.submit(np.arange(3, dtype=np.int32), max_new_tokens=4)
        srv.run()
    assert cat.warmed
    rid = srv.submit(np.arange(20, dtype=np.int32) % 7, max_new_tokens=4)
    srv.run()
    assert cat.recompiles >= 1
    evs = [e for e in rec.events(kind="compile") if e["recompile"]]
    assert evs and evs[-1]["op"] == "prefill" and evs[-1]["seconds"] >= 0
    assert any(e["phase"] == "compile_stall" for e in srv.journey(rid))


def test_phases_ride_the_tick_events_and_the_metrics():
    """Each tick's wall split into the reference's phases, published as
    ``serving_tick_phase_seconds{phase}`` and embedded in the recorder's
    tick events; the snapshot rides ``device_costs()``,
    ``utilization()``, ``/stats`` and a postmortem."""
    from paddle_tpu_torch.inference import serve_metrics
    import json
    import urllib.request
    tele = ServerTelemetry()
    rec = FlightRecorder()
    cat = CostCatalog(registry=tele.registry)
    srv = _server(telemetry=tele, costs=cat, recorder=rec)
    for p in _prompts(2):
        srv.submit(p, max_new_tokens=4)
    srv.run()
    snap = srv.device_costs()
    assert snap["last_tick_phases"] \
        and set(snap["last_tick_phases"]) <= set(TICK_PHASES)
    h = tele.registry.get("serving_tick_phase_seconds")
    assert h.labels(phase="decode_launch").count > 0
    assert h.labels(phase="prefill_launch").count > 0
    ticks = rec.events(kind="tick")
    assert ticks and all(set(t["phases"]) <= set(TICK_PHASES)
                         for t in ticks)
    assert srv.utilization()["mfu"] == cat.mfu() > 0
    ms = serve_metrics(srv)
    try:
        with urllib.request.urlopen(ms.url + "/stats", timeout=10) as f:
            stats = json.loads(f.read())["stats"]
    finally:
        ms.close()
    assert stats["costs"]["ops"] == json.loads(json.dumps(snap["ops"]))
    bundle = srv._postmortem_locked("probe")
    assert bundle["costs"]["ops"] == cat.snapshot()["ops"]

"""Decode bundles for the Llama family: ``generate()`` and the serving
step functions.

Port of ``paddle_tpu/models/generation.py``. Each causal LM decomposes
into plain step functions over its parameters and a KV cache, in one of
two layouts:

- dense (``cache_backend="dense"``, ``generate()``'s and every prefill's):
  one ``[batch, max_cache_len, kv_heads, head_dim]`` K and V buffer a
  layer (``{"k": [layers, ...], "v": ...}``), written at per-row or
  shared offsets and attended in plain torch (``_cached_attend``: GQA
  repeat, masked softmax in f32), as the reference computes it in plain
  jnp outside any ``pallas_call``;
- paged: one global K/V page pool per layer (``[layers, num_pages,
  page_size, kv_heads, head_dim]``) plus per-slot block tables
  (``[slots, pages_per_slot]`` int32). Decode steps (one token per
  slot) run the paged-attention kernel; ragged prefill chunks (several
  slots' prompt chunks in one call) run the ragged-prefill kernel; a
  fused tick (every slot's prefill chunk and decode row in one call,
  over the pages its schedule lists) runs the fused-tick kernel.
  Each kernel takes its plain PyTorch version on CPU tensors.

Where the JAX package returns new cache arrays, the port writes caches
IN PLACE (``index_put_`` or a slice on the layer's view): a cache is the
largest tensor of a serving process, and a copy per layer per step
would double it. The step functions still return the cache dict so call
sites read like the JAX ones.

Int8 weights and caches, the mesh, beam search and constrained decoding
are not ported yet; asking for them raises ``NotImplementedError``
naming the ROADMAP item.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from ..nn.layer import Linear
from ..ops.kernels.fused_tick import fused_tick_attention
from ..ops.kernels.paged_attention import paged_attention
from ..ops.kernels.ragged_prefill import ragged_prefill_attention
from ..ops.rope import apply_rotary, precompute_freqs

__all__ = ["GenerationMixin"]


def _rms(x, w, eps):
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * w


NEG = -1e30        # the masked logit of the reference's _cached_attend


def _positions(t, b, s, device=None):
    """Absolute positions [B, s] for a step at per-row offsets ``t``
    ([B] tensor) or one shared offset (a Python int or a 0-d tensor), on
    ``t``'s device or, for a Python int, on ``device``."""
    row = torch.arange(s, dtype=torch.int32,
                       device=t.device if torch.is_tensor(t) else device)
    if not torch.is_tensor(t) or t.dim() == 0:
        return (row + t)[None, :].repeat(b, 1)
    return t[:, None] + row[None, :]


def _per_slot(t, b, device):
    """``t`` as a [B] int32 tensor (a scalar broadcasts to every slot)."""
    if torch.is_tensor(t) and t.dim() == 1:
        return t
    return torch.full((b,), int(t), dtype=torch.int32, device=device)


def _cached_attend(q, k_cache, v_cache, t, s, scale):
    """q [B, s, nh, hd] at positions [t, t + s); caches [B, T, nh, hd]
    already written through t + s. Key position p is visible to query
    row r iff p <= t + r (unwritten and future rows masked with -1e30
    before an f32 softmax). ``t`` a Python int, a 0-d tensor or [B]."""
    T = k_cache.shape[1]
    logits = torch.einsum("bsnd,btnd->bnst", q, k_cache) * scale
    pos = torch.arange(T, device=q.device)
    row = _positions(t, q.shape[0], s, q.device)            # [B, s]
    ok = pos[None, None] <= row[:, :, None]                 # [B, s, T]
    logits = torch.where(ok[:, None], logits.float(), NEG)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", p, v_cache)


def _write_cache(cache, kv, t):
    """cache [B, T, h, hd] <- kv [B, s, h, hd] at positions [t, t + s), in
    place; returns ``cache``.

    A shared offset (a Python int or a 0-d tensor) is a slice write. The
    reference's ``dynamic_update_slice`` clamps a start past ``T - s``;
    every caller bound-checks first, so here it raises. Per-row offsets
    ([B]) are the reference's scatter, which DROPS positions >= T (the
    wasted block steps of a slot that ends at ``max_cache_len``, idle
    dense slots whose offset keeps growing); torch's ``index_put_``
    raises there on the CPU and asserts on CUDA, so those positions are
    masked: at s == 1 (the decode step) the row is written back with
    the value it holds, with no host sync; at s > 1 they are left out."""
    T = cache.shape[1]
    b, s = kv.shape[0], kv.shape[1]
    kv = kv.to(cache.dtype)
    if not torch.is_tensor(t) or t.dim() == 0:
        t0 = int(t)
        if t0 < 0 or t0 + s > T:
            raise ValueError(f"cache write of rows [{t0}, {t0 + s}) lies "
                             f"outside the cache's {T} rows")
        cache[:, t0:t0 + s] = kv
        return cache
    rows = torch.arange(b, device=cache.device)
    if s == 1:
        col = t.long()
        oob = col >= T
        col = col.clamp(max=T - 1)
        cache[rows, col] = torch.where(oob[:, None, None], cache[rows, col],
                                       kv[:, 0])
        return cache
    pos = _positions(t, b, s).long()
    keep = pos < T
    cache[rows[:, None].expand(b, s)[keep], pos[keep]] = kv[keep]
    return cache


def _check_cache_dtype(cache_dtype):
    if cache_dtype == "int8":
        raise NotImplementedError(
            "cache_dtype='int8' is not ported (ROADMAP, Queue 1 item 10: "
            "quantized serving)")


def _init_kv(shape, dtype, cache_dtype, device):
    """Dense caches ``{"k", "v"}`` of ``shape`` ([layers, batch,
    max_cache_len, kv_heads, head_dim]), zeroed."""
    _check_cache_dtype(cache_dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _check_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh serving is not ported (ROADMAP, Queue 1 item 9: the "
            "fleet's kv-head-sharded pool)")


def _check_paged_config(max_cache_len, page_size, num_pages, cache_dtype,
                        mesh):
    """Validate a paged decode bundle request. ``page_size`` must divide
    ``max_cache_len`` so the block table spans exactly the cache
    length."""
    _check_cache_dtype(cache_dtype)
    _check_mesh(mesh)
    if not page_size or int(page_size) < 1:
        raise ValueError("paged backend needs page_size >= 1")
    if not num_pages or int(num_pages) < 2:
        raise ValueError("paged backend needs num_pages >= 2 (page 0 is "
                         "the reserved null page)")
    if max_cache_len % int(page_size):
        raise ValueError(
            f"page_size ({page_size}) must divide max_cache_len "
            f"({max_cache_len})")


def _init_paged_kv(batch, layers, num_pages, page_size, pages_per_slot,
                   kvh, hd, dtype, device):
    """Paged cache: one K/V page pool per layer plus the per-slot block
    table (page 0 is the null page every unused entry points at)."""
    shape = (layers, num_pages, page_size, kvh, hd)
    return {"pool": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)},
            "bt": torch.zeros((batch, pages_per_slot), dtype=torch.int32,
                              device=device)}


def _page_write(pool, kv, bt, t):
    """pool [P, pg, h, hd] <- kv [B, 1, h, hd] at per-slot positions
    ``t``, in place. A position past the block-table width goes to the
    null page (page 0) with a ZEROED payload, so the wasted decode
    steps of finished, parked or idle slots never touch a live slot's
    pages and never store a non-finite value where every slot's unused
    table entries point. Returns ``pool``."""
    pg = pool.shape[1]
    b = kv.shape[0]
    maxp = bt.shape[1]
    t = _per_slot(t, b, pool.device).long()
    pidx = t // pg
    oob = pidx >= maxp
    rows = torch.arange(b, device=pool.device)
    page = torch.where(oob, torch.zeros_like(pidx),
                       bt[rows, pidx.clamp(max=maxp - 1)].long())
    vals = kv[:, 0].to(pool.dtype)
    vals = torch.where(oob[:, None, None], torch.zeros_like(vals), vals)
    pool[page, t % pg] = vals
    return pool


def _page_write_seq(pool, kv, bt, t, last=None):
    """Ragged-prefill page write, in place: pool [P, pg, h, hd] <- kv
    [B, s, h, hd] at per-slot position runs [t_b, t_b + s). Same
    null-page rule as ``_page_write``: positions past the table (the
    idle sentinel's rows) go to page 0 zeroed. Positions inside the
    table but past a slot's allocation land in its null-page entries —
    finite garbage the length masks hide. ``last`` ([B], optional)
    null-redirects rows past each slot's last valid position too.
    Returns ``pool``."""
    pg = pool.shape[1]
    b, s = kv.shape[0], kv.shape[1]
    maxp = bt.shape[1]
    t = _per_slot(t, b, pool.device)
    pos = _positions(t, b, s).long()                       # [B, s]
    pidx = pos // pg
    oob = pidx >= maxp
    if last is not None:
        oob = oob | (pos > last.long()[:, None])
    page = torch.where(oob, torch.zeros_like(pidx),
                       torch.gather(bt.long(), 1, pidx.clamp(max=maxp - 1)))
    vals = kv.to(pool.dtype)
    vals = torch.where(oob[..., None, None], torch.zeros_like(vals), vals)
    n = b * s
    pool[page.reshape(n), (pos % pg).reshape(n)] = \
        vals.reshape((n,) + vals.shape[2:])
    return pool


def _paged_attend(q, k_pool, v_pool, bt, t, scale):
    """Decode-step attention through the block table: q [B, 1, nh, hd],
    pools [P, pg, kvh, hd], valid lengths t + 1 (the cache is already
    written through t). Returns [B, 1, nh, hd]."""
    t = _per_slot(t, q.shape[0], q.device)
    lengths = (t + 1).to(torch.int32)
    return paged_attention(q[:, 0], k_pool, v_pool, bt, lengths,
                           scale)[:, None]


def _paged_prefill_attend(q, k_pool, v_pool, bt, t, scale):
    """Ragged prefill attention through the block table: q [B, s, nh, hd]
    chunk rows at per-slot offsets ``t``; row j of slot b attends to
    positions <= t_b + j. A slot carrying the idle sentinel (``t`` past
    the table's span) gets ``last = -1``, so the kernel skips it and
    its rows read as zeros."""
    b, s = q.shape[0], q.shape[1]
    t = _per_slot(t, b, q.device)
    limit = bt.shape[1] * k_pool.shape[1]          # tokens a table spans
    last = torch.where(t >= limit, torch.full_like(t, -1), t + s - 1)
    return ragged_prefill_attention(q, k_pool, v_pool, bt, t,
                                    last=last.to(torch.int32),
                                    sm_scale=scale)


def _fused_attend(q, k_pool, v_pool, bt, t, last, dec, ss, sp, scale):
    """Fused-tick attention through the LIVE block-table slice ``bt``:
    q [B, C, nh, hd] packed row groups (a prefill chunk, a single decode
    row, or idle garbage per slot) at per-slot offsets ``t``, over the
    page schedule ``(ss, sp)`` that lists only live pages. Idle slots
    (``last < 0``) read as zeros."""
    return fused_tick_attention(q, k_pool, v_pool, bt, t, last, dec, ss, sp,
                                sm_scale=scale)


def _rope_gqa_attn(blk, xx, kc, vc, t, pos, dims, tables, eps, bt=None,
                   fused=None):
    """Llama attention sublayer for one layer of a step: pre-RMSNorm,
    rope at absolute positions, K/V written into the layer's cache,
    attention, output projection and residual. ``bt`` None: ``kc``/``vc``
    are the layer's dense caches [B, T, kvh, hd], written by
    ``_write_cache`` and attended by ``_cached_attend`` over the kv heads
    repeated to the query heads. ``bt`` given: they are the layer's page
    pools, written and attended through the block table (s == 1: decode
    kernel; s > 1: ragged prefill kernel). ``fused`` (a ``(last, dec, ss,
    sp)`` tuple) switches to the fused tick: ``bt`` is then the live
    block-table slice, rows past ``last`` null-redirect zeroed on write,
    and attention runs the fused-tick kernel over the page schedule
    ``(ss, sp)``. Returns (xx, h2) with h2 the post-attention norm for
    the FFN."""
    b, s, nh, kvh, hd, scale = dims
    cos, sin = tables
    h = _rms(xx, blk["ln1"], eps)
    q = (h @ blk["wq"]).reshape(b, s, nh, hd)
    k = (h @ blk["wk"]).reshape(b, s, kvh, hd)
    v = (h @ blk["wv"]).reshape(b, s, kvh, hd)
    q = apply_rotary(q, cos, sin, position_ids=pos)
    k = apply_rotary(k, cos, sin, position_ids=pos)
    if bt is None:
        _write_cache(kc, k, t)
        _write_cache(vc, v, t)
        rep = nh // kvh
        kk = kc.repeat_interleave(rep, dim=2) if rep > 1 else kc
        vv = vc.repeat_interleave(rep, dim=2) if rep > 1 else vc
        att = _cached_attend(q, kk, vv, t, s, scale)
    elif fused is not None:
        last, dec, ss, sp = fused
        _page_write_seq(kc, k, bt, t, last=last)
        _page_write_seq(vc, v, bt, t, last=last)
        att = _fused_attend(q, kc, vc, bt, t, last, dec, ss, sp, scale)
    elif s > 1:
        _page_write_seq(kc, k, bt, t)
        _page_write_seq(vc, v, bt, t)
        att = _paged_prefill_attend(q, kc, vc, bt, t, scale)
    else:
        _page_write(kc, k, bt, t)
        _page_write(vc, v, bt, t)
        att = _paged_attend(q, kc, vc, bt, t, scale)
    xx = xx + att.reshape(b, s, nh * hd) @ blk["wo"]
    h2 = _rms(xx, blk["ln2"], eps)
    return xx, h2


def _make_ragged_prefill_fn(step_fn, head_fn, embed_tokens):
    """The paged bundle's ragged-prefill entry point:
    ``(tokens [S, C], t0 [S], caches, out_idx [S]) -> (logits [S, V],
    caches)``. ``tokens`` holds one right-padded chunk per slot, ``t0``
    each chunk's absolute start (an idle slot carries
    ``t0 = max_cache_len``: its writes null-redirect and its rows are
    garbage nobody reads), ``out_idx`` the row of each slot's last
    prompt token; ``logits[s]`` is that row's next-token distribution."""
    @torch.no_grad()
    def ragged_prefill(tokens, t0, caches, out_idx):
        S = tokens.shape[0]
        x = embed_tokens(tokens, t0)
        out, caches = step_fn(x, caches, t0)
        rows = out[torch.arange(S, device=out.device),
                   out_idx.long()][:, None]                 # [S, 1, H]
        return head_fn(rows)[:, -1], caches

    return ragged_prefill


def _make_fused_tick_fn(fused_step, head_fn, embed_tokens):
    """The paged bundle's fused-tick entry point: one whole serving tick
    — every slot's prefill chunk at its prefix offset AND every live
    slot's s=1 decode row — as one pass over the layers, with one
    fused-tick kernel launch per layer.

    Signature: ``(tokens [S, C], t0 [S], last [S], dec [S], caches,
    out_idx [S], bt_live [S, W], sched_slot [G], sched_page [G],
    has_decode=None) -> (logits [S, V], caches)``. Per slot: a prefill
    chunk carries ``t0 = fill position``, ``last = t0 + take - 1``; a
    decode row carries its token in column 0 with ``t0 = last = t``
    (the write position) and ``dec = 1``; an idle slot carries ``last =
    -1`` (its writes null-redirect zeroed, the kernel skips it).
    ``out_idx`` picks the logits row: the last prompt token of a
    completing prefill, row 0 for decode. ``bt_live`` is the block tables' first W columns (any W
    covering the live frontier; the server passes the whole table, whose
    width fixes the bf16 decode body's split plan) and ``(sched_slot,
    sched_page)`` the live-page schedule
    (``ops.kernels.fused_tick.build_schedule``).

    A decode row computes the same bits whatever else its tick packs:
    when the tick also carries prefill chunks (C > 1), the decode rows
    take a pass of their own at the shapes of a decode-only tick
    (``[S, 1]`` rows, so projections at M = S and the fused-tick
    kernel's C = 1 body) and the prefill rows another, each pass with
    the other's slots idle. Two kernel launches a layer on such a tick.
    On the card a GEMM's rounding depends on its M, so one pass at
    M = S * C would give a decode row other bits than a decode-only tick
    gives it, and a replayed request would not redraw its parked tokens.
    ``has_decode`` (a host bool) says whether ``dec`` has a live row;
    None reads it from ``dec``."""
    @torch.no_grad()
    def fused_tick(tokens, t0, last, dec, caches, out_idx, bt_live,
                   sched_slot, sched_page, has_decode=None):
        S, C = tokens.shape
        ar = torch.arange(S, device=tokens.device)
        if has_decode is None:
            has_decode = bool((dec > 0).any())
        if C == 1 or not has_decode:
            out, caches = fused_step(embed_tokens(tokens, t0), caches, t0,
                                     last, dec, bt_live, sched_slot,
                                     sched_page)
            rows = out[ar, out_idx.long()]
        else:
            is_dec = dec > 0
            idle = torch.full_like(last, -1)
            out_d, caches = fused_step(
                embed_tokens(tokens[:, :1].contiguous(), t0), caches, t0,
                torch.where(is_dec, last, idle), dec, bt_live, sched_slot,
                sched_page)
            out_p, caches = fused_step(
                embed_tokens(tokens, t0), caches, t0,
                torch.where(is_dec, idle, last), dec, bt_live, sched_slot,
                sched_page)
            rows = torch.where(is_dec[:, None], out_d[:, 0],
                               out_p[ar, out_idx.long()])
        return head_fn(rows[:, None])[:, -1], caches

    return fused_tick


def _make_llama_decode_fns(model, max_cache_len, weight_dtype=None,
                           mesh=None, cache_dtype=None,
                           cache_backend="dense", page_size=None,
                           num_pages=None):
    """``(init_caches, embed_fn, step_fn, head_fn)`` for a dense
    ``LlamaForCausalLM``, and ``(..., ragged_fn, fused_fn)`` for a paged
    one: GQA-aware (kv heads cached unrepeated), rope at absolute
    positions, the layer scan a Python loop over layers. Dense caches
    are ``[batch, max_cache_len, kv_heads, head_dim]`` a layer. The
    functions read the model's parameters in place (no stacked copy) and
    run under ``torch.no_grad``: the parameters are trainable, serving
    builds no graph."""
    if weight_dtype == "int8":
        raise NotImplementedError(
            "weight_dtype='int8' is not ported (ROADMAP, Queue 1 item 10: "
            "quantized serving)")
    paged = cache_backend == "paged"
    if paged:
        _check_paged_config(max_cache_len, page_size, num_pages,
                            cache_dtype, mesh)
    else:
        _check_cache_dtype(cache_dtype)
        _check_mesh(mesh)
    projections = [model.lm_head] + [
        p for blk in model.model.layers
        for p in (blk.self_attn.q_proj, blk.self_attn.k_proj,
                  blk.self_attn.v_proj, blk.self_attn.o_proj,
                  blk.mlp.gate_proj, blk.mlp.up_proj, blk.mlp.down_proj)]
    if not all(isinstance(p, Linear) for p in projections):
        raise NotImplementedError(
            "serving a model converted by to_int8_inference is not ported "
            "(ROADMAP, Queue 1 item 10: quantized serving)")
    cfg = model.cfg
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_eps
    L = cfg.num_layers
    device, dtype = model.device, model.dtype
    table = model.model.embed_tokens.weight
    norm = model.model.norm.weight
    head = model.lm_head.weight                            # [H, V]
    blocks = [{"ln1": blk.input_layernorm.weight,
               "ln2": blk.post_attention_layernorm.weight,
               "wq": blk.self_attn.q_proj.weight,
               "wk": blk.self_attn.k_proj.weight,
               "wv": blk.self_attn.v_proj.weight,
               "wo": blk.self_attn.o_proj.weight,
               "wg": blk.mlp.gate_proj.weight,
               "wu": blk.mlp.up_proj.weight,
               "wd": blk.mlp.down_proj.weight}
              for blk in model.model.layers]
    tables = precompute_freqs(hd, max_cache_len, cfg.rope_theta,
                              device=device)
    scale = 1.0 / math.sqrt(hd)

    def init_caches(batch):
        if paged:
            return _init_paged_kv(batch, L, int(num_pages), int(page_size),
                                  max_cache_len // int(page_size), kvh, hd,
                                  dtype, device)
        return _init_kv((L, batch, max_cache_len, kvh, hd), dtype,
                        cache_dtype, device)

    @torch.no_grad()
    def embed_fn(tok, t):
        return table[tok.long()][:, None, :]

    def _run_layers(x, caches, t, bt, fused=None):
        b, s = x.shape[0], x.shape[1]
        if bt is not None:
            t = _per_slot(t, b, x.device)
            kv = zip(caches["pool"]["k"], caches["pool"]["v"])
        else:
            kv = zip(caches["k"], caches["v"])
        pos = _positions(t, b, s, x.device)                # [B, s]
        dims = (b, s, nh, kvh, hd, scale)
        for blk, (kc, vc) in zip(blocks, kv):
            x, h2 = _rope_gqa_attn(blk, x, kc, vc, t, pos, dims, tables,
                                   eps, bt, fused=fused)
            x = x + (F.silu(h2 @ blk["wg"]) * (h2 @ blk["wu"])) @ blk["wd"]
        return x, caches

    @torch.no_grad()
    def step_fn(x, caches, t):
        return _run_layers(x, caches, t, caches["bt"] if paged else None)

    @torch.no_grad()
    def head_fn(out):
        return (_rms(out, norm, eps) @ head).float()

    if not paged:
        return init_caches, embed_fn, step_fn, head_fn

    @torch.no_grad()
    def fused_step(x, caches, t, last, dec, bt_live, ss, sp):
        return _run_layers(x, caches, t, bt_live, fused=(last, dec, ss, sp))

    @torch.no_grad()
    def embed_tokens(tokens, t0):
        return table[tokens.long()]

    ragged = _make_ragged_prefill_fn(step_fn, head_fn, embed_tokens)
    fused = _make_fused_tick_fn(fused_step, head_fn, embed_tokens)
    return init_caches, embed_fn, step_fn, head_fn, ragged, fused


class GenerationMixin:
    """``generate()`` (greedy and seeded sampled) and the decode bundles
    of a causal LM."""

    def _decode_bundle(self, max_cache_len, weight_dtype=None, mesh=None,
                       cache_dtype=None, cache_backend="dense",
                       page_size=None, num_pages=None):
        """The JAX package's bundle layouts: dense ``(init_caches,
        embed_fn, step_fn, head_fn, prefill_fn)`` (element 4 is the
        prefill step, here the same ``step_fn``), paged ``(...,
        ragged_fn, fused_fn)`` with the ragged-prefill entry in element 5
        and the fused-tick entry in element 6 (``_make_fused_tick_fn``).
        Bundles are cached on the model by their arguments, least
        recently used first out past 4 (the server's dense and paged
        pair twice over); call ``reset_generate_cache()`` after
        replacing parameters (loading in place needs nothing)."""
        key = (max_cache_len, weight_dtype,
               None if mesh is None else id(mesh), cache_dtype,
               cache_backend, page_size, num_pages)
        cached = getattr(self, "_pt_decode_cache", None)
        if cached is None:
            cached = self._pt_decode_cache = {}
        if key in cached:
            cached[key] = cached.pop(key)        # LRU: move to the back
            return cached[key]
        from .llama import LlamaForCausalLM
        if not isinstance(self, LlamaForCausalLM):
            raise NotImplementedError(
                f"decoding {type(self).__name__} is not ported (ROADMAP, "
                f"Queue 1 item 11: other paged families)")
        fns = _make_llama_decode_fns(
            self, max_cache_len, weight_dtype, mesh, cache_dtype,
            cache_backend=cache_backend, page_size=page_size,
            num_pages=num_pages)
        bundle = fns[:4] + (fns[2],) + fns[4:]
        cached[key] = bundle
        while len(cached) > 4:
            cached.pop(next(iter(cached)))
        return bundle

    def _prefill_embed(self, ids):
        """[B, T] ids (a tensor on the model's device) -> [B, T, H] input
        embeddings of a multi-token step (Llama has no learned
        positions)."""
        return self.model.embed_tokens.weight[ids.long()]

    @torch.no_grad()
    def _run_prefill(self, bundle, ids_np, chunk=None, caches=None, t0=0):
        """Prefill ``ids_np`` [B, T] starting at position ``t0`` (fresh
        dense caches unless ``caches`` resumes a partly filled set, e.g.
        a prefix hit); returns (last-position logits [B, V], caches).

        ``chunk``: feed the prompt in fixed-size chunks (the prompt padded
        up to a multiple); the padded rows lie above the valid frontier,
        where the causal mask hides them and decode overwrites them."""
        init_caches, _, _, head_fn, prefill = bundle[:5]
        B, T = ids_np.shape
        if caches is None:
            caches = init_caches(B)
        dev = self.device
        if not chunk or chunk >= T:
            x0 = self._prefill_embed(torch.from_numpy(ids_np).to(dev))
            out, caches = prefill(x0, caches, int(t0))
            return head_fn(out[:, -1:])[:, -1], caches
        pad = (-T) % chunk
        cache_rows = caches["k"].shape[2]
        if t0 + T + pad > cache_rows:
            raise ValueError(
                f"chunked prefill writes rows up to {t0 + T + pad} "
                f"(prompt {T} at offset {t0} padded to a multiple of "
                f"{chunk}) but max_cache_len is {cache_rows} — raise "
                f"max_cache_len by at least {chunk - 1} for chunk "
                f"headroom")
        ids = torch.from_numpy(np.pad(ids_np, ((0, 0), (0, pad)))).to(dev)
        last = None
        for i in range(0, T + pad, chunk):
            x = self._prefill_embed(ids[:, i:i + chunk])
            out, caches = prefill(x, caches, int(t0 + i))
            if i <= T - 1 < i + chunk:
                last = head_fn(out[:, T - 1 - i:T - i])[:, -1]
        return last, caches

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 seed=None, max_cache_len=None, weight_dtype=None,
                 prefill_chunk=None, mesh=None, cache_dtype=None,
                 num_beams=1, fsm=None):
        """Continuations of ``input_ids`` ([B, T] or [T] ints: a tensor,
        an array or a list) on the model's device. Returns the FULL
        sequence (prompt + ``max_new_tokens``) as an int32 tensor on the
        model's device; once a row has emitted ``eos_token_id`` the rest
        of it is eos.

        Greedy when ``do_sample=False``; otherwise each token is drawn
        with ONE key over the whole ``[B, V]`` batch, ``categorical`` of
        the ``temperature``/``top_k``/``top_p``-filtered logits (its
        Gumbel noise one R2 launch a draw on the card), from
        ``PRNGKey(seed)``; ``seed=None`` draws a seed from numpy's global
        RNG, so repeated calls differ. Tokens equal the JAX package's.
        The decode functions are built from the model's parameters and
        cached per ``max_cache_len``; call ``reset_generate_cache()``
        after replacing parameters.

        ``prefill_chunk`` prefills in fixed-size chunks (the prompt
        padded to a multiple, which ``max_cache_len`` must hold). Beam
        search and ``fsm`` (item 12), int8 weights and caches (item 10)
        and ``mesh`` (item 9) raise ``NotImplementedError``."""
        from ..inference.decode_loop import greedy_generate, sample_generate
        if num_beams > 1 or fsm is not None:
            raise NotImplementedError(
                "generate(num_beams > 1) and generate(fsm=) are not ported "
                "(ROADMAP, Queue 1 item 12: remaining inference modules)")
        if torch.is_tensor(input_ids):
            input_ids = input_ids.detach().cpu().numpy()
        ids_np = np.asarray(input_ids)
        if ids_np.ndim == 1:
            ids_np = ids_np[None]
        ids_np = ids_np.astype(np.int32)
        B, T = ids_np.shape
        pad = (-T) % prefill_chunk if prefill_chunk else 0
        if max_cache_len is None:
            max_cache_len = min(self.cfg.max_seq_len,
                                max(T + max_new_tokens, T + pad))
        if T + max_new_tokens > max_cache_len:
            raise ValueError(
                f"prompt ({T}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_cache_len ({max_cache_len})")
        bundle = self._decode_bundle(max_cache_len, weight_dtype, mesh,
                                     cache_dtype)
        init_caches, embed_fn, step_fn, head_fn, _ = bundle
        last_logits, caches = self._run_prefill(bundle, ids_np,
                                                chunk=prefill_chunk)
        if do_sample:
            if seed is None:        # fresh entropy per call, as the
                seed = int(np.random.randint(0, 2**31))   # reference's
            new_ids, _ = sample_generate(
                embed_fn, step_fn, head_fn, caches, last_logits, T,
                max_new_tokens, prng.PRNGKey(seed),
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_token_id=eos_token_id)
        else:
            first = torch.argmax(last_logits, -1).to(torch.int32)
            new_ids, _ = greedy_generate(
                embed_fn, step_fn, head_fn, caches, first, T,
                max_new_tokens, eos_token_id=eos_token_id)
        prompt = torch.from_numpy(ids_np).to(new_ids.device)
        return torch.cat([prompt, new_ids], dim=1)

    def reset_generate_cache(self):
        """Drop the cached decode bundles (call after replacing
        parameters)."""
        self._pt_decode_cache = None

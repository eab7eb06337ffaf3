"""Paged decode bundle for the Llama family: the serving step functions.

Port of the paged subset of ``paddle_tpu/models/generation.py``. Each
causal LM decomposes into plain step functions over its parameters and
a paged KV cache: one global K/V page pool per layer
(``[layers, num_pages, page_size, kv_heads, head_dim]``) plus per-slot
block tables (``[slots, pages_per_slot]`` int32). Decode steps (one
token per slot) run the paged-attention kernel; ragged prefill chunks
(several slots' prompt chunks in one call) run the ragged-prefill
kernel; a fused tick (every slot's prefill chunk and decode row in one
call, over the live slice of the block tables) runs the fused-tick
kernel. Each kernel takes its plain PyTorch version on CPU tensors.

Where the JAX package returns new cache arrays, the port writes pool
pages IN PLACE (``index_put_`` on the layer's pool view): the pool is
the largest tensor of a serving process, and a copy per layer per step
would double it. The step functions still return the cache dict so
call sites read like the JAX ones.

The dense cache backend, int8 weights and caches and the mesh are not
ported yet; asking for them raises ``NotImplementedError`` naming the
ROADMAP item.
"""
import math

import torch
import torch.nn.functional as F

from ..ops.kernels.fused_tick import fused_tick_attention
from ..ops.kernels.paged_attention import paged_attention
from ..ops.kernels.ragged_prefill import ragged_prefill_attention
from ..ops.rope import apply_rotary, precompute_freqs

__all__ = ["GenerationMixin"]


def _rms(x, w, eps):
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * w


def _positions(t, b, s):
    """Absolute positions [B, s] for a step at per-row offsets ``t``
    ([B] tensor) or one shared offset (a Python int)."""
    row = torch.arange(s, dtype=torch.int32,
                       device=t.device if torch.is_tensor(t) else None)
    if not torch.is_tensor(t) or t.dim() == 0:
        return (row + t)[None, :].repeat(b, 1)
    return t[:, None] + row[None, :]


def _per_slot(t, b, device):
    """``t`` as a [B] int32 tensor (a scalar broadcasts to every slot)."""
    if torch.is_tensor(t) and t.dim() == 1:
        return t
    return torch.full((b,), int(t), dtype=torch.int32, device=device)


def _check_paged_config(max_cache_len, page_size, num_pages, cache_dtype,
                        mesh):
    """Validate a paged decode bundle request. ``page_size`` must divide
    ``max_cache_len`` so the block table spans exactly the cache
    length."""
    if cache_dtype == "int8":
        raise NotImplementedError(
            "cache_dtype='int8' is not ported (ROADMAP, Queue 1 item 10: "
            "quantized serving)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh serving is not ported (ROADMAP, Queue 1 item 9: the "
            "fleet)")
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


def _rope_gqa_attn(blk, xx, k_pool, v_pool, t, pos, dims, tables, eps, bt,
                   fused=None):
    """Llama attention sublayer for one layer of a paged step:
    pre-RMSNorm, rope at absolute positions, K/V written into the
    layer's pool pages, paged attention (s == 1: decode kernel; s > 1:
    ragged prefill kernel), output projection and residual. ``fused``
    (a ``(last, dec, ss, sp)`` tuple) switches to the fused tick:
    ``bt`` is then the live block-table slice, rows past ``last``
    null-redirect zeroed on write, and attention runs the fused-tick
    kernel over the page schedule ``(ss, sp)``. Returns (xx, h2) with
    h2 the post-attention norm for the FFN."""
    b, s, nh, kvh, hd, scale = dims
    cos, sin = tables
    h = _rms(xx, blk["ln1"], eps)
    q = (h @ blk["wq"]).reshape(b, s, nh, hd)
    k = (h @ blk["wk"]).reshape(b, s, kvh, hd)
    v = (h @ blk["wv"]).reshape(b, s, kvh, hd)
    q = apply_rotary(q, cos, sin, position_ids=pos)
    k = apply_rotary(k, cos, sin, position_ids=pos)
    if fused is not None:
        last, dec, ss, sp = fused
        _page_write_seq(k_pool, k, bt, t, last=last)
        _page_write_seq(v_pool, v, bt, t, last=last)
        att = _fused_attend(q, k_pool, v_pool, bt, t, last, dec, ss, sp,
                            scale)
    elif s > 1:
        _page_write_seq(k_pool, k, bt, t)
        _page_write_seq(v_pool, v, bt, t)
        att = _paged_prefill_attend(q, k_pool, v_pool, bt, t, scale)
    else:
        _page_write(k_pool, k, bt, t)
        _page_write(v_pool, v, bt, t)
        att = _paged_attend(q, k_pool, v_pool, bt, t, scale)
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
    out_idx [S], bt_live [S, W], sched_slot [G], sched_page [G]) ->
    (logits [S, V], caches)``. Per slot: a prefill chunk carries
    ``t0 = fill position``, ``last = t0 + take - 1``; a decode row
    carries its token in column 0 with ``t0 = last = t`` (the write
    position) and ``dec = 1``; an idle slot carries ``last = -1`` (its
    writes null-redirect zeroed, the kernel skips it). ``out_idx`` picks
    the logits row: the last prompt token of a completing prefill, row 0
    for decode. ``bt_live`` is the block tables sliced to the live page
    frontier and ``(sched_slot, sched_page)`` the live-page schedule
    (``ops.kernels.fused_tick.build_schedule``)."""
    @torch.no_grad()
    def fused_tick(tokens, t0, last, dec, caches, out_idx, bt_live,
                   sched_slot, sched_page):
        S = tokens.shape[0]
        x = embed_tokens(tokens, t0)
        out, caches = fused_step(x, caches, t0, last, dec, bt_live,
                                 sched_slot, sched_page)
        rows = out[torch.arange(S, device=out.device),
                   out_idx.long()][:, None]                 # [S, 1, H]
        return head_fn(rows)[:, -1], caches

    return fused_tick


def _make_llama_decode_fns(model, max_cache_len, weight_dtype=None,
                           mesh=None, cache_dtype=None,
                           cache_backend="dense", page_size=None,
                           num_pages=None):
    """(init_caches, embed_fn, step_fn, head_fn, ragged_fn, fused_fn)
    for a paged
    ``LlamaForCausalLM``: GQA-aware (kv heads cached unrepeated), rope at
    absolute positions, the layer scan a Python loop over layers. The
    functions read the model's parameters in place (no stacked copy) and
    run under ``torch.no_grad``: the parameters are trainable, serving
    builds no graph."""
    if cache_backend != "paged":
        raise NotImplementedError(
            "cache_backend='dense' is not ported (ROADMAP, Queue 1 item 5: "
            "the dense backend); use cache_backend='paged'")
    if weight_dtype == "int8":
        raise NotImplementedError(
            "weight_dtype='int8' is not ported (ROADMAP, Queue 1 item 10: "
            "quantized serving)")
    _check_paged_config(max_cache_len, page_size, num_pages, cache_dtype,
                        mesh)
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
    page_size, num_pages = int(page_size), int(num_pages)

    def init_caches(batch):
        return _init_paged_kv(batch, L, num_pages, page_size,
                              max_cache_len // page_size, kvh, hd, dtype,
                              device)

    @torch.no_grad()
    def embed_fn(tok, t):
        return table[tok.long()][:, None, :]

    def _run_layers(x, caches, t, bt, fused=None):
        b, s = x.shape[0], x.shape[1]
        t = _per_slot(t, b, x.device)
        pos = _positions(t, b, s)                          # [B, s]
        dims = (b, s, nh, kvh, hd, scale)
        for blk, k_pool, v_pool in zip(blocks, caches["pool"]["k"],
                                       caches["pool"]["v"]):
            x, h2 = _rope_gqa_attn(blk, x, k_pool, v_pool, t, pos, dims,
                                   tables, eps, bt, fused=fused)
            x = x + (F.silu(h2 @ blk["wg"]) * (h2 @ blk["wu"])) @ blk["wd"]
        return x, caches

    @torch.no_grad()
    def step_fn(x, caches, t):
        return _run_layers(x, caches, t, caches["bt"])

    @torch.no_grad()
    def fused_step(x, caches, t, last, dec, bt_live, ss, sp):
        return _run_layers(x, caches, t, bt_live, fused=(last, dec, ss, sp))

    @torch.no_grad()
    def head_fn(out):
        return (_rms(out, norm, eps) @ head).float()

    @torch.no_grad()
    def embed_tokens(tokens, t0):
        return table[tokens.long()]

    ragged = _make_ragged_prefill_fn(step_fn, head_fn, embed_tokens)
    fused = _make_fused_tick_fn(fused_step, head_fn, embed_tokens)
    return init_caches, embed_fn, step_fn, head_fn, ragged, fused


class GenerationMixin:
    """The paged decode bundle of a causal LM."""

    def _decode_bundle(self, max_cache_len, weight_dtype=None, mesh=None,
                       cache_dtype=None, cache_backend="dense",
                       page_size=None, num_pages=None):
        """``(init_caches, embed_fn, step_fn, head_fn, step_fn,
        ragged_fn, fused_fn)`` — the JAX package's paged bundle layout:
        the jitted step in element 4 (here the same eager ``step_fn``),
        the ragged-prefill entry in element 5 and the fused-tick entry
        in element 6 (``_make_fused_tick_fn``). The dense backend, int8
        and the mesh are not ported."""
        from .llama import LlamaForCausalLM
        if not isinstance(self, LlamaForCausalLM):
            raise NotImplementedError(
                f"the paged decode bundle is ported for LlamaForCausalLM "
                f"only, not {type(self).__name__} (ROADMAP, Queue 1 item 11: "
                f"other paged families)")
        init, embed, step, head, ragged, fused = _make_llama_decode_fns(
            self, max_cache_len, weight_dtype, mesh, cache_dtype,
            cache_backend=cache_backend, page_size=page_size,
            num_pages=num_pages)
        return init, embed, step, head, step, ragged, fused

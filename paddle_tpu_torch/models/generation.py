"""Decode bundles of the causal LMs (Llama, Mixtral and GPT):
``generate()`` and the serving step functions.

Port of ``paddle_tpu/models/generation.py``. Each causal LM decomposes
into plain step functions over its parameters and a KV cache, in one of
two layouts:

- dense (``cache_backend="dense"``, ``generate()``'s and every prefill's):
  one ``[batch, max_cache_len, kv_heads, head_dim]`` K and V buffer a
  layer (``{"k": [layers, ...], "v": ...}``), written at per-row or
  shared offsets and attended in plain torch (``_cached_attend``: GQA
  repeat, masked softmax in f32), as the reference computes it in plain
  jnp outside any ``pallas_call``. ``cache_dtype="int8"`` stores int8
  rows with an f32 scale a (row, position, head) in ``"ks"`` / ``"vs"``
  (``_kv_write``, ``_kv_read``);
- paged: one global K/V page pool per layer (``[layers, num_pages,
  page_size, kv_heads, head_dim]``) plus per-slot block tables
  (``[slots, pages_per_slot]`` int32). Decode steps (one token per
  slot) run the paged-attention kernel; ragged prefill chunks (several
  slots' prompt chunks in one call) run the ragged-prefill kernel; a
  fused tick (every slot's prefill chunk and decode row in one call,
  over the pages its schedule lists) runs the fused-tick kernel.
  Each kernel takes its plain PyTorch version on CPU tensors.

The three families share the cache and attention paths (``_attend``):
Llama and Mixtral through ``_rope_gqa_attn``, GPT (learned positions,
LayerNorm, a fused qkv projection, a tied head, MHA) through its own
layer. ``weight_dtype="int8"`` quantises every matmul weight per layer
(and expert) and output channel (``_quantize_tree``); the products
dequantise in plain torch (``_mm``, ``_emm``), as the reference does in
plain jnp.

Where the JAX package returns new cache arrays, the port writes caches
IN PLACE (``index_put_`` or a slice on the layer's view): a cache is the
largest tensor of a serving process, and a copy per layer per step
would double it. The step functions still return the cache dict so call
sites read like the JAX ones.

The mesh is not ported yet; asking for it raises
``NotImplementedError`` naming the ROADMAP item.
A paged int8 cache, and serving a model converted by
``to_int8_inference``, are refused as the reference refuses them.
"""
import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from ..nn.layers_basic import Linear
from ..ops.kernels.fused_tick import fused_tick_attention
from ..ops.kernels.paged_attention import paged_attention
from ..ops.kernels.ragged_prefill import ragged_prefill_attention
from ..ops.rope import apply_rotary, precompute_freqs

__all__ = ["GenerationMixin"]


# ------------------------------------------------ weight-only int8

_QUANT_WEIGHTS = frozenset({
    "wq", "wk", "wv", "wo", "wg", "wu", "wd",            # llama/mixtral
    "attn.qkv.weight", "attn.proj.weight",               # gpt
    "mlp.fc1.weight", "mlp.fc2.weight",
})


@torch.no_grad()
def _quantize(w):
    """``(int8 codes, f32 scales)`` of ``w`` ``[..., K, N]``: one scale an
    output channel (and leading index: layer, expert), ``amax / 127 +
    1e-12`` in f32, codes ``round(w / scale)`` (half to even) clipped to
    +-127. The divisors are tensors: torch on CUDA multiplies by the
    reciprocal of a host scalar, the reference (eager) divides. No
    graph: the weights are trainable parameters, and a scale built under
    autograd would keep a full-size ``|w|`` alive in its graph."""
    amax = w.abs().amax(dim=-2, keepdim=True).float()
    s = amax / torch.full((), 127.0, dtype=torch.float32,
                          device=w.device) + 1e-12
    qw = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return qw, s


def _quantize_tree(p):
    """Weight-only int8 of a layer's weights ``p`` (``{name: tensor}``):
    every matmul weight on the reference's allowlist (``_QUANT_WEIGHTS``)
    becomes an ``(int8, f32 scale)`` pair with per-output-channel scales
    (``_quantize``); norms, embeddings, the router, biases and the lm
    head stay in full precision."""
    return {k: _quantize(v) if k in _QUANT_WEIGHTS else v
            for k, v in p.items()}


def _stamp(blocks):
    """``(data_ptr, version)`` of every weight of ``blocks`` that
    ``_quantize_tree`` quantizes: a write in place (a load, an
    optimizer step) bumps the version, a ``.data`` swap moves the
    pointer."""
    return tuple((w.data_ptr(), w._version) for blk in blocks
                 for k, w in blk.items() if k in _QUANT_WEIGHTS)


class _Int8Blocks(list):
    """A model's quantized layers, shared by its int8 bundles (held by
    the model through a weak reference: the last bundle dropped frees
    them), with the weights they were made from and their stamp."""

    def __init__(self, blocks):
        super().__init__(_quantize_tree(blk) for blk in blocks)
        self.sources = blocks
        self.stamp = _stamp(blocks)

    def stale(self):
        """Whether a weight it was made from changed since."""
        return _stamp(self.sources) != self.stamp


def _int8_blocks(model, blocks):
    """The quantized copy of ``blocks`` (the model's per-layer weight
    dicts), shared by every live int8 bundle of ``model`` made from the
    same weights (the server's dense and paged pair hold one copy, as
    the model keeps its own full-precision parameters); quantized
    again once a weight has changed."""
    ref = getattr(model, "_pt_int8_blocks", None)
    q = ref() if ref is not None else None
    if q is None or q.stamp != _stamp(blocks):
        q = _Int8Blocks(blocks)
        model._pt_int8_blocks = weakref.ref(q)
    return q


def _mm(x, w):
    """``x @ w`` where ``w`` is a tensor or an ``(int8, scale)`` pair: the
    codes cast to x's type, the product scaled per output channel, the
    scale cast to x's type first (the reference's order)."""
    if isinstance(w, tuple):
        qw, s = w
        return (x @ qw.to(x.dtype)) * s.to(x.dtype)
    return x @ w


def _expert_up(x, w):
    """``einsum("bsh,ehf->besf", x, w)`` as one batch of matmuls over the
    experts, ``w [E, H, F]`` read as it lies (``torch.einsum`` permutes
    it to ``[H, E * F]`` and copies every expert matrix a call)."""
    b, s, h = x.shape
    out = torch.matmul(x.reshape(1, b * s, h), w)          # [E, b*s, F]
    return out.view(w.shape[0], b, s, -1).transpose(0, 1)


def _expert_down(x, w):
    """``einsum("besf,efh->besh", x, w)``, batched over the experts."""
    b, e, s, f = x.shape
    out = torch.matmul(x.transpose(0, 1).reshape(e, b * s, f), w)
    return out.view(e, b, s, -1).transpose(0, 1)


def _emm(bmm, x, w):
    """``_mm`` of the stacked expert weights through ``bmm``
    (``_expert_up`` or ``_expert_down``): an ``(int8, scale)`` pair's
    scale ``[E, 1, N]`` broadcast over the token dim."""
    if isinstance(w, tuple):
        qw, s = w
        return bmm(x, qw.to(x.dtype)) * s.to(x.dtype)
    return bmm(x, w)


def _rms(x, w, eps):
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * w


def _ln(x, w, b, eps):
    """LayerNorm of the decode bundles (the reference's ``_ln``):
    statistics in f32, the biased variance of the centred values."""
    xf = x.float()
    c = xf - xf.mean(-1, keepdim=True)
    var = c.square().mean(-1, keepdim=True)
    return (c * torch.rsqrt(var + eps)).to(x.dtype) * w + b


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


def _learned_positions(wpe, pos):
    """Rows of the learned position table ``wpe`` ``[P, H]`` at ``pos``
    (any shape). A position past the table reads zeros: the reference's
    jnp gather fills NaN there (an idle slot's padded rows, which the
    null-page write zeroes and nobody reads); a torch index past the
    table raises on the CPU and is a device-side assert on the card."""
    n = wpe.shape[0]
    rows = wpe[pos.long().clamp(0, n - 1)]
    return torch.where((pos < n)[..., None], rows,
                       torch.zeros((), dtype=rows.dtype,
                                   device=rows.device))


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
    """cache [B, T, ...] <- kv [B, s, ...] at positions [t, t + s), in
    place; returns ``cache`` (the K/V rows ``[..., h, hd]`` or an int8
    cache's scales ``[..., h]``).

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
        oob = (col >= T).view((b,) + (1,) * (kv.dim() - 2))
        col = col.clamp(max=T - 1)
        cache[rows, col] = torch.where(oob, cache[rows, col], kv[:, 0])
        return cache
    pos = _positions(t, b, s).long()
    keep = pos < T
    cache[rows[:, None].expand(b, s)[keep], pos[keep]] = kv[keep]
    return cache


# the reference quantises the KV rows inside its jitted step, where XLA
# turns the division by 127 into a product with its f32 reciprocal
_INV127 = float(np.float32(1) / np.float32(127))


def _kv_write(lc, name, kv, t):
    """Write new k or v rows ``kv`` ``[B, s, h, hd]`` into this layer's
    cache dict ``lc``, in place. With an int8 cache (a ``<name>s`` scale
    entry present) the rows are quantised per (row, position, head):
    scale ``(amax + 1e-8) / 127`` in f32, int8 codes half to even."""
    if name + "s" in lc:
        kf = kv.float()
        sc = (kf.abs().amax(-1) + 1e-8) * _INV127
        q = torch.clamp(torch.round(kf / sc[..., None]), -127, 127)
        _write_cache(lc[name], q.to(torch.int8), t)
        _write_cache(lc[name + "s"], sc, t)
    else:
        _write_cache(lc[name], kv, t)
    return lc


def _kv_read(lc, name, dtype):
    """The layer's whole cache ``[B, T, h, hd]`` in ``dtype`` (an int8
    cache dequantised: codes times their scales)."""
    c = lc[name]
    if name + "s" in lc:
        return c.to(dtype) * lc[name + "s"].to(dtype)[..., None]
    return c


def _check_cache_dtype(cache_dtype):
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"cache_dtype must be None or 'int8', got "
                         f"{cache_dtype!r}")


def _init_kv(shape, dtype, cache_dtype, device):
    """Dense caches of ``shape`` ([layers, batch, max_cache_len,
    kv_heads, head_dim]), zeroed: ``{"k", "v"}`` in ``dtype``, or with
    ``cache_dtype="int8"`` int8 ``k``/``v`` and f32 scales ``ks``/``vs``
    of ``shape[:-1]``."""
    _check_cache_dtype(cache_dtype)
    if cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device)}
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
    length. An int8 cache is refused on the pool, as the reference
    refuses it (``paddle_tpu/models/generation.py:258-262``)."""
    if cache_dtype == "int8":
        raise NotImplementedError(
            "cache_dtype='int8' is not wired for the paged backend, in "
            "the reference either (its generation.py refuses it, naming "
            "its ROADMAP item 3: a quantized paged KV pool); use "
            "cache_backend='dense' with int8 caches")
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


def _attend(q, k, v, lc, t, dims, bt=None, fused=None):
    """K/V rows written into one layer's cache and q attended over it,
    every family's path. ``bt`` None: ``lc`` holds the layer's dense
    caches (``{"k", "v"}`` [B, T, kvh, hd], with ``"ks"``/``"vs"`` when
    int8), written by ``_kv_write`` and attended by ``_cached_attend``
    over the kv heads repeated to the query heads. ``bt`` given: ``lc``
    holds the layer's page pools, written and attended through the
    block table (s == 1: decode kernel; s > 1: ragged prefill kernel).
    ``fused`` (a ``(last, dec, ss, sp)`` tuple) switches to the fused
    tick: ``bt`` is then the live block-table slice, rows past ``last``
    null-redirect zeroed on write, and attention runs the fused-tick
    kernel over the page schedule ``(ss, sp)``. Returns [B, s, nh, hd]."""
    b, s, nh, kvh, hd, scale = dims
    kc, vc = lc["k"], lc["v"]
    if bt is not None:
        q = q.contiguous()         # the kernels' contract (GPT's is a view)
    if bt is None:
        _kv_write(lc, "k", k, t)
        _kv_write(lc, "v", v, t)
        kc, vc = _kv_read(lc, "k", q.dtype), _kv_read(lc, "v", q.dtype)
        rep = nh // kvh
        kk = kc.repeat_interleave(rep, dim=2) if rep > 1 else kc
        vv = vc.repeat_interleave(rep, dim=2) if rep > 1 else vc
        return _cached_attend(q, kk, vv, t, s, scale)
    if fused is not None:
        last, dec, ss, sp = fused
        _page_write_seq(kc, k, bt, t, last=last)
        _page_write_seq(vc, v, bt, t, last=last)
        return _fused_attend(q, kc, vc, bt, t, last, dec, ss, sp, scale)
    if s > 1:
        _page_write_seq(kc, k, bt, t)
        _page_write_seq(vc, v, bt, t)
        return _paged_prefill_attend(q, kc, vc, bt, t, scale)
    _page_write(kc, k, bt, t)
    _page_write(vc, v, bt, t)
    return _paged_attend(q, kc, vc, bt, t, scale)


def _rope_gqa_attn(blk, xx, lc, t, pos, dims, tables, eps, bt=None,
                   fused=None):
    """The Llama-family attention sublayer (Llama and Mixtral) for one
    layer of a step: pre-RMSNorm, q/k/v projections, rope at absolute
    positions, ``_attend`` over the layer's cache ``lc``, the output
    projection and the residual. Returns (xx, h2) with h2 the
    post-attention norm for the FFN."""
    b, s, nh, kvh, hd, _ = dims
    cos, sin = tables
    h = _rms(xx, blk["ln1"], eps)
    q = _mm(h, blk["wq"]).reshape(b, s, nh, hd)
    k = _mm(h, blk["wk"]).reshape(b, s, kvh, hd)
    v = _mm(h, blk["wv"]).reshape(b, s, kvh, hd)
    q = apply_rotary(q, cos, sin, position_ids=pos)
    k = apply_rotary(k, cos, sin, position_ids=pos)
    att = _attend(q, k, v, lc, t, dims, bt, fused)
    xx = xx + _mm(att.reshape(b, s, nh * hd), blk["wo"])
    h2 = _rms(xx, blk["ln2"], eps)
    return xx, h2


def _moe_topk_ffn(h, router_w, wg, wu, wd, top_k):
    """Dropless dense-expert MoE FFN of the decode bundles (the
    reference's): every expert runs, and each token combines the
    outputs of its top-k experts by their gates normalised over the k
    (softmax of the router's logits in f32; the first maximum taken,
    then the first maximum of the rest)."""
    E = router_w.shape[-1]
    probs = torch.softmax((h @ router_w).float(), -1)            # [b, s, E]
    i1 = probs.argmax(-1)
    g1 = torch.gather(probs, -1, i1[..., None])[..., 0]
    one1 = F.one_hot(i1, E).to(probs.dtype)
    if top_k >= 2:
        probs2 = probs * (1.0 - one1)
        i2 = probs2.argmax(-1)
        g2 = torch.gather(probs2, -1, i2[..., None])[..., 0]
        denom = g1 + g2 + 1e-9
        w = one1 * (g1 / denom)[..., None] \
            + F.one_hot(i2, E).to(probs.dtype) * (g2 / denom)[..., None]
    else:
        w = one1 * g1[..., None]
    g = _emm(_expert_up, h, wg)
    u = _emm(_expert_up, h, wu)
    o = _emm(_expert_down, F.silu(g) * u, wd)
    return torch.einsum("bse,besh->bsh", w.to(o.dtype), o)


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


def _check_float_layers(layers):
    """Refuse a model whose projections ``to_int8_inference`` converted,
    as the reference does: its bundles stack trainable parameters
    (``raw_params``), and ``Int8InferLinear`` holds its weight as
    buffers."""
    if not all(isinstance(p, Linear) for p in layers):
        raise NotImplementedError(
            "serving a model converted by to_int8_inference is refused, "
            "as in the reference (its decode bundles read trainable "
            "parameters, and an Int8InferLinear holds its weight as "
            "buffers); serve the float model with weight_dtype='int8'")


def _bundle(model, max_cache_len, weight_dtype, mesh, cache_dtype,
            cache_backend, page_size, num_pages, blocks, heads, layer_fn,
            embed_fn, embed_tokens, head_fn):
    """The decode functions of one family from its pieces: ``blocks``
    (a weight dict a layer, quantized here for ``weight_dtype="int8"``),
    ``heads`` (nh, kvh, hd), ``layer_fn(blk, x, lc, t, pos, dims, bt,
    fused) -> x`` (one layer of a step over its cache ``lc``),
    ``embed_fn(tok, t)`` (a decode step's ``[B, 1, H]`` input),
    ``embed_tokens(tokens, t0)`` (a paged prefill or fused tick's
    ``[S, C, H]``) and ``head_fn`` (hidden rows -> f32 logits).
    Returns the dense ``(init_caches, embed_fn, step_fn, head_fn)`` or
    the paged ``(..., ragged_fn, fused_fn)``. The layer loop is a
    Python loop; every function runs under ``torch.no_grad``."""
    if weight_dtype not in (None, "int8"):
        raise ValueError(f"weight_dtype must be None or 'int8', got "
                         f"{weight_dtype!r}")
    paged = cache_backend == "paged"
    if paged:
        _check_paged_config(max_cache_len, page_size, num_pages,
                            cache_dtype, mesh)
    else:
        _check_cache_dtype(cache_dtype)
        _check_mesh(mesh)
    if weight_dtype == "int8":
        blocks = _int8_blocks(model, blocks)
    nh, kvh, hd = heads
    L = len(blocks)
    device, dtype = model.device, model.dtype
    scale = 1.0 / math.sqrt(hd)

    def init_caches(batch):
        if paged:
            return _init_paged_kv(batch, L, int(num_pages), int(page_size),
                                  max_cache_len // int(page_size), kvh, hd,
                                  dtype, device)
        return _init_kv((L, batch, max_cache_len, kvh, hd), dtype,
                        cache_dtype, device)

    def _run_layers(x, caches, t, bt, fused=None):
        b, s = x.shape[0], x.shape[1]
        if bt is not None:
            t = _per_slot(t, b, x.device)
            src = caches["pool"]
        else:
            src = caches
        pos = _positions(t, b, s, x.device)                # [B, s]
        dims = (b, s, nh, kvh, hd, scale)
        for i, blk in enumerate(blocks):
            lc = {n: c[i] for n, c in src.items()}
            x = layer_fn(blk, x, lc, t, pos, dims, bt, fused)
        return x, caches

    @torch.no_grad()
    def step_fn(x, caches, t):
        return _run_layers(x, caches, t, caches["bt"] if paged else None)

    step_fn.weights = blocks      # what the bundle reads a step, per layer
    embed = torch.no_grad()(embed_fn)
    head = torch.no_grad()(head_fn)
    if not paged:
        return init_caches, embed, step_fn, head

    @torch.no_grad()
    def fused_step(x, caches, t, last, dec, bt_live, ss, sp):
        return _run_layers(x, caches, t, bt_live, fused=(last, dec, ss, sp))

    embed_tokens = torch.no_grad()(embed_tokens)
    ragged = _make_ragged_prefill_fn(step_fn, head, embed_tokens)
    fused = _make_fused_tick_fn(fused_step, head, embed_tokens)
    return init_caches, embed, step_fn, head, ragged, fused


def _make_llama_decode_fns(model, max_cache_len, weight_dtype=None,
                           mesh=None, cache_dtype=None,
                           cache_backend="dense", page_size=None,
                           num_pages=None):
    """The decode functions of a ``LlamaForCausalLM`` (``_llama_family``)
    with the SwiGLU FFN."""
    def ffn_projs(blk):
        return blk.mlp.gate_proj, blk.mlp.up_proj, blk.mlp.down_proj

    def ffn_weights(blk):
        m = blk.mlp
        return {"wg": m.gate_proj.weight, "wu": m.up_proj.weight,
                "wd": m.down_proj.weight}

    def ffn(blk, h2):
        return _mm(F.silu(_mm(h2, blk["wg"])) * _mm(h2, blk["wu"]),
                   blk["wd"])

    return _llama_family(model, max_cache_len, weight_dtype, mesh,
                         cache_dtype, cache_backend, page_size, num_pages,
                         ffn_projs, ffn_weights, ffn)


def _make_mixtral_decode_fns(model, max_cache_len, weight_dtype=None,
                             mesh=None, cache_dtype=None,
                             cache_backend="dense", page_size=None,
                             num_pages=None):
    """The decode functions of a ``MixtralForCausalLM``
    (``_llama_family``) with the dense-expert top-k FFN
    (``_moe_topk_ffn``). The router stays in full precision."""
    top_k = model.cfg.top_k

    def ffn_projs(blk):
        return (blk.moe.gate.gate,)

    def ffn_weights(blk):
        moe = blk.moe
        return {"router": moe.gate.gate.weight, "wg": moe.experts.w_gate,
                "wu": moe.experts.w_up, "wd": moe.experts.w_down}

    def ffn(blk, h2):
        return _moe_topk_ffn(h2, blk["router"], blk["wg"], blk["wu"],
                             blk["wd"], top_k)

    return _llama_family(model, max_cache_len, weight_dtype, mesh,
                         cache_dtype, cache_backend, page_size, num_pages,
                         ffn_projs, ffn_weights, ffn)


def _llama_family(model, max_cache_len, weight_dtype, mesh, cache_dtype,
                  cache_backend, page_size, num_pages, ffn_projs,
                  ffn_weights, ffn):
    """``_bundle`` of a Llama-backbone model: GQA-aware attention (kv
    heads cached unrepeated, rope at absolute positions:
    ``_rope_gqa_attn``), token embeddings (no learned positions), rope
    tables for ``max_cache_len`` positions, the final RMSNorm and an
    untied head. The family gives its FFN: ``ffn_projs(blk)`` (the
    block's FFN projections, checked float), ``ffn_weights(blk)`` (its
    FFN weights by bundle name) and ``ffn(weights, h2)``. The float bundle reads the model's parameters
    in place (no stacked copy): the parameters are trainable, serving
    builds no graph."""
    cfg = model.cfg
    layers = model.model.layers
    _check_float_layers([model.lm_head] + [
        p for blk in layers
        for p in (blk.self_attn.q_proj, blk.self_attn.k_proj,
                  blk.self_attn.v_proj, blk.self_attn.o_proj,
                  *ffn_projs(blk))])
    blocks = [{"ln1": blk.input_layernorm.weight,
               "ln2": blk.post_attention_layernorm.weight,
               "wq": blk.self_attn.q_proj.weight,
               "wk": blk.self_attn.k_proj.weight,
               "wv": blk.self_attn.v_proj.weight,
               "wo": blk.self_attn.o_proj.weight, **ffn_weights(blk)}
              for blk in layers]
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_eps
    table = model.model.embed_tokens.weight
    norm = model.model.norm.weight
    head = model.lm_head.weight                            # [H, V]
    tables = precompute_freqs(hd, max_cache_len, cfg.rope_theta,
                              device=model.device)

    def layer(blk, x, lc, t, pos, dims, bt, fused):
        x, h2 = _rope_gqa_attn(blk, x, lc, t, pos, dims, tables, eps, bt,
                               fused=fused)
        return x + ffn(blk, h2)

    def embed_fn(tok, t):
        return table[tok.long()][:, None, :]

    def embed_tokens(tokens, t0):
        return table[tokens.long()]

    def head_fn(out):
        return (_rms(out, norm, eps) @ head).float()

    return _bundle(model, max_cache_len, weight_dtype, mesh, cache_dtype,
                   cache_backend, page_size, num_pages, blocks,
                   (nh, kvh, hd), layer, embed_fn, embed_tokens, head_fn)


_GPT_WEIGHTS = ("ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias",
                "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                "attn.proj.bias", "mlp.fc1.weight", "mlp.fc1.bias",
                "mlp.fc2.weight", "mlp.fc2.bias")


def _make_gpt_decode_fns(model, max_cache_len, weight_dtype=None,
                         mesh=None, cache_dtype=None, cache_backend="dense",
                         page_size=None, num_pages=None):
    """The decode functions of a ``GPTForCausalLM``: learned positions
    (``_learned_positions``: zeros past the table), pre-LayerNorm
    (``_ln``), the fused qkv projection, MHA, tanh GELU and the head
    tied to the token table. A cache longer than the position table is
    refused, as in the reference."""
    cfg = model.cfg
    if max_cache_len > cfg.max_seq_len:
        raise ValueError(
            f"max_cache_len ({max_cache_len}) exceeds the learned "
            f"position table ({cfg.max_seq_len}); positions past it "
            f"would silently clamp — shorten the cache or grow wpe")
    layers = model.gpt.blocks
    _check_float_layers([p for blk in layers
                         for p in (blk.attn.qkv, blk.attn.proj,
                                   blk.mlp.fc1, blk.mlp.fc2)])
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    eps = cfg.layer_norm_eps
    table = model.gpt.wte.weight                 # [V, H], the tied head
    wpe = model.gpt.wpe.weight
    lnf_w, lnf_b = model.gpt.ln_f.weight, model.gpt.ln_f.bias
    params = [dict(blk.named_parameters()) for blk in layers]
    blocks = [{n: p[n] for n in _GPT_WEIGHTS} for p in params]

    def layer(blk, x, lc, t, pos, dims, bt, fused):
        b, s = x.shape[0], x.shape[1]
        h = _ln(x, blk["ln1.weight"], blk["ln1.bias"], eps)
        qkv = (_mm(h, blk["attn.qkv.weight"]) + blk["attn.qkv.bias"]
               ).reshape(b, s, 3, nh, hd)
        att = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], lc, t,
                      dims, bt, fused)
        x = x + (_mm(att.reshape(b, s, nh * hd), blk["attn.proj.weight"])
                 + blk["attn.proj.bias"])
        h2 = _ln(x, blk["ln2.weight"], blk["ln2.bias"], eps)
        ff = F.gelu(_mm(h2, blk["mlp.fc1.weight"]) + blk["mlp.fc1.bias"],
                    approximate="tanh")
        return x + _mm(ff, blk["mlp.fc2.weight"]) + blk["mlp.fc2.bias"]

    def embed_fn(tok, t):
        pos = _per_slot(t, tok.shape[0], tok.device)
        return (table[tok.long()] + _learned_positions(wpe, pos))[:, None]

    def embed_tokens(tokens, t0):
        pos = _positions(t0, tokens.shape[0], tokens.shape[1],
                         tokens.device)
        return table[tokens.long()] + _learned_positions(wpe, pos)

    def head_fn(out):
        return (_ln(out, lnf_w, lnf_b, eps) @ table.t()).float()

    return _bundle(model, max_cache_len, weight_dtype, mesh, cache_dtype,
                   cache_backend, page_size, num_pages, blocks, (nh, nh, hd),
                   layer, embed_fn, embed_tokens, head_fn)


class GenerationMixin:
    """``generate()`` (greedy, seeded sampled, beam search and
    constrained) and the decode bundles of a causal LM."""

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
        replacing parameters. Loading in place needs nothing: a float
        bundle reads the parameters, and an int8 bundle whose quantized
        copy a weight's change made stale (``_Int8Blocks.stale``) is
        built again.

        Dispatch over the families as in the reference: Mixtral, Llama,
        GPT; any other model is refused, as the reference refuses it."""
        key = (max_cache_len, weight_dtype,
               None if mesh is None else id(mesh), cache_dtype,
               cache_backend, page_size, num_pages)
        cached = getattr(self, "_pt_decode_cache", None)
        if cached is None:
            cached = self._pt_decode_cache = {}
        bundle = cached.pop(key, None)
        if bundle is not None and not (weight_dtype == "int8"
                                       and bundle[2].weights.stale()):
            cached[key] = bundle                 # LRU: move to the back
            return bundle
        from .gpt import GPTForCausalLM
        from .llama import LlamaForCausalLM
        from .mixtral import MixtralForCausalLM
        if isinstance(self, MixtralForCausalLM):
            make = _make_mixtral_decode_fns
        elif isinstance(self, LlamaForCausalLM):
            make = _make_llama_decode_fns
        elif isinstance(self, GPTForCausalLM):
            make = _make_gpt_decode_fns
        else:
            raise NotImplementedError(
                f"generate() is not wired for {type(self).__name__}, in "
                f"the reference either (its families: Llama, Mixtral, "
                f"GPT)")
        fns = make(self, max_cache_len, weight_dtype, mesh, cache_dtype,
                   cache_backend=cache_backend, page_size=page_size,
                   num_pages=num_pages)
        bundle = fns[:4] + (fns[2],) + fns[4:]
        cached[key] = bundle
        while len(cached) > 4:
            cached.pop(next(iter(cached)))
        return bundle

    def _prefill_embed(self, ids, t0=0):
        """[B, T] ids (a tensor on the model's device) -> [B, T, H] input
        embeddings of a multi-token step starting at position ``t0``
        (GPT adds its learned positions ``t0 .. t0 + T - 1``; the Llama
        backbone has none)."""
        from .gpt import GPTForCausalLM
        if isinstance(self, GPTForCausalLM):
            pos = int(t0) + torch.arange(ids.shape[1], device=ids.device)
            return self.gpt.wte.weight[ids.long()] + _learned_positions(
                self.gpt.wpe.weight, pos)[None]
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
            x0 = self._prefill_embed(torch.from_numpy(ids_np).to(dev), t0)
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
            x = self._prefill_embed(ids[:, i:i + chunk], t0 + i)
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
        padded to a multiple, which ``max_cache_len`` must hold).
        ``weight_dtype="int8"`` decodes with weight-only int8 matmul
        weights (per-channel scales; embeddings, norms, the router and
        the head in full precision), ``cache_dtype="int8"`` with int8
        dense caches. ``mesh`` (item 9) raises ``NotImplementedError``.

        ``num_beams > 1``: beam search (``beam_generate``; the best beam).
        ``fsm=(mask, next[, start_state])``: constrained decoding
        (``fsm_generate``), greedy or sampled from ``PRNGKey(seed or
        0)``. Neither composes with beam search, and beam search not
        with sampling (``ValueError``s, as in the reference)."""
        from ..inference.decode_loop import (beam_generate, fsm_generate,
                                             greedy_generate,
                                             sample_generate)
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
        if fsm is not None:
            if num_beams > 1:
                raise ValueError("constrained decoding composes with "
                                 "greedy/sampling, not beam search")
            mask_tab, next_tab = fsm[0], fsm[1]
            start = fsm[2] if len(fsm) > 2 else 0
            if do_sample and seed is None:       # greedy never draws
                seed = int(np.random.randint(0, 2**31))
            new_ids, _ = fsm_generate(
                embed_fn, step_fn, head_fn, caches, last_logits, T,
                max_new_tokens, mask_tab, next_tab, start_state=start,
                do_sample=do_sample, key=prng.PRNGKey(seed or 0),
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_token_id=eos_token_id)
        elif num_beams > 1:
            if do_sample:
                raise ValueError("beam search and sampling are mutually "
                                 "exclusive (reference decode semantics)")
            new_ids, _ = beam_generate(
                embed_fn, step_fn, head_fn, caches, last_logits, T,
                max_new_tokens, num_beams, eos_token_id=eos_token_id)
        elif do_sample:
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
        """Drop the cached decode bundles and the int8 copy they share
        (call after replacing parameters)."""
        self._pt_decode_cache = None
        self._pt_int8_blocks = None

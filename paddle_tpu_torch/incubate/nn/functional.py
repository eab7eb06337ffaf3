"""paddle.incubate.nn.functional parity: the fused functional ops.

Port of ``paddle_tpu/incubate/nn/functional.py``. Each op is the
reference's composition in torch over the port's ``nn.functional``, so
the kernels come where ``nn.functional`` takes them:

- ``fused_linear_activation`` / ``fused_matmul_bias``: ``act(x @ w +
  b)`` through ``fused_gemm_epilogue`` (K7), forward and backward; a
  batched or transposed-x ``fused_matmul_bias`` is a matmul plus add, as
  in the reference;
- ``fused_rotary_position_embedding`` (``ops.rope``'s): q and k in one
  K6 launch on the card without ``position_ids``;
- ``fused_rms_norm``: K5 (``F.rms_norm``);
- ``fused_multi_transformer``: a stack of pre- or post-LN layers, its
  attention the flash kernel (K4a, causal) without a cache and the
  reference's masked composition over a growing (``cache_kvs``) or a
  static (``cache_kvs`` with ``time_step``) cache;
- the dropouts (``fused_dropout_add``, the bias-dropout-residual-LN,
  ``fused_feedforward``, ``fused_multi_head_attention``) draw their keys
  where the reference does, so one ``seed()`` gives the same masks; on
  the card R2 draws and applies them;
- the rest (``fused_ec_moe``, ``fused_layer_norm``, ``swiglu``, the two
  ``fused_softmax_mask*``) is plain torch, as the reference leaves them
  to XLA.

Every op takes the paddle API's ``Tensor`` (in lists too) as well as
torch tensors, and returns the kind it was given.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as tf

from ...nn import functional as F
from ...nn.layer import _has_tensor, _unwrap_tree, _wrap_tree
from ...ops.kernels.gemm_epilogue import fused_gemm_epilogue as _epilogue
from ...ops.rope import fused_rotary_position_embedding as _fused_rope

__all__ = ["fused_multi_transformer", "fused_matmul_bias",
           "fused_ec_moe",
           "fused_multi_head_attention", "fused_feedforward",
           "fused_bias_dropout_residual_layer_norm", "fused_linear",
           "fused_linear_activation", "fused_rotary_position_embedding",
           "fused_rms_norm", "fused_layer_norm", "swiglu",
           "fused_dropout_add"]


def _takes_tensor(fn):
    """``fn`` of torch tensors, taking the paddle ``Tensor`` too: the
    arguments unwrapped (in lists and tuples as well), the outputs
    wrapped when any argument was a ``Tensor``."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if not (_has_tensor(args) or _has_tensor(kwargs.values())):
            return fn(*args, **kwargs)
        out = fn(*_unwrap_tree(list(args)),
                 **{k: _unwrap_tree(v) for k, v in kwargs.items()})
        return _wrap_tree(out)
    return entry


def _reverse(t):
    """``jnp``'s ``.T``: every axis reversed (a transpose in 2-D)."""
    return t.permute(*reversed(range(t.dim())))


def _swap_last(t):
    """paddle matmul's ``transpose_x``/``transpose_y``: the last two axes
    swapped, a 1-D operand left as it is."""
    return t.transpose(-1, -2) if t.dim() > 1 else t


def _add(x, b):
    return x if b is None else x + b


@_takes_tensor
def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``x @ weight (+ bias)``; ``transpose_weight`` takes ``weight.T``."""
    return _add(x @ (_reverse(weight) if transpose_weight else weight), bias)


@_takes_tensor
def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    """cublasLt epilogue parity: ``act(x @ y + bias)`` in one pass, K7
    on the card (x's leading dims flattened), its plain version on the
    CPU; differentiable in x, y and bias. ``activation`` is ``none``,
    ``relu`` or ``gelu`` (the tanh form)."""
    a = _reverse(x) if trans_x else x
    b = _reverse(y) if trans_y else y
    return _epilogue(a, b, bias, activation)


@_takes_tensor
def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """A 2-D ``y`` without ``transpose_x`` runs K7 (no activation);
    batched or transposed-x operands take a matmul plus add."""
    if y.dim() == 2 and not transpose_x:
        return fused_linear_activation(x, y, bias, trans_x=False,
                                       trans_y=transpose_y,
                                       activation="none")
    return _add((_swap_last(x) if transpose_x else x)
                @ (_swap_last(y) if transpose_y else y), bias)


fused_rotary_position_embedding = _takes_tensor(_fused_rope)


@_takes_tensor
def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True):
    """``layer_norm(residual + dropout(x + bias))``."""
    out = F.dropout(_add(x, bias), p=dropout_rate, training=training)
    out = out + residual
    return F.layer_norm(out, out.shape[-1], ln_scale, ln_bias, ln_epsilon)


@_takes_tensor
def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train"):
    return F.dropout(x, p=p, training=training, mode=mode) + y


@_takes_tensor
def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kw):
    """RMSNorm over the last dim (K5), plus ``norm_bias`` when given."""
    return _add(F.rms_norm(x, norm_weight, epsilon), norm_bias)


@_takes_tensor
def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5, **kw):
    return F.layer_norm(x, x.shape[-1], norm_weight, norm_bias, epsilon)


@_takes_tensor
def swiglu(x, y=None):
    """``silu(a) * b``: of x's two halves, or of x and y."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


@_takes_tensor
def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, num_heads=None, **kw):
    """The functional FusedMultiHeadAttention: (pre-LN), the qkv
    projection split into ``[b, s, 3, heads, head_dim]``, scaled
    dot-product attention (K4 without a mask or attention dropout), the
    output projection, dropout, the residual and (post-LN). ``num_heads``
    defaults to a head dim of 64, as in the reference."""
    residual = x
    d = x.shape[-1]
    if pre_layer_norm:
        x = F.layer_norm(x, d, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    qkv = fused_linear(x, qkv_weight, qkv_bias)
    b, s = qkv.shape[0], qkv.shape[1]
    nh = num_heads or (qkv.shape[-1] // 3 // 64)
    hd = qkv.shape[-1] // 3 // nh
    q, k, v = qkv.reshape(b, s, 3, nh, hd).unbind(2)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                         dropout_p=attn_dropout_rate,
                                         training=training)
    out = fused_linear(out.reshape(b, s, nh * hd), linear_weight,
                       linear_bias)
    out = F.dropout(out, p=dropout_rate, training=training) + residual
    if not pre_layer_norm:
        out = F.layer_norm(out, d, ln_scale, ln_bias, ln_epsilon)
    return out


@_takes_tensor
def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, **kw):
    """(pre-LN), ``linear2(dropout(act(linear1(x))))``, dropout, the
    residual and (post-LN)."""
    residual = x
    d = x.shape[-1]
    if pre_layer_norm:
        x = F.layer_norm(x, d, ln1_scale, ln1_bias, ln1_epsilon)
    act = getattr(F, activation)
    h = act(fused_linear(x, linear1_weight, linear1_bias))
    h = F.dropout(h, p=dropout1_rate, training=training)
    h = fused_linear(h, linear2_weight, linear2_bias)
    out = residual + F.dropout(h, p=dropout2_rate, training=training)
    if not pre_layer_norm:
        out = F.layer_norm(out, d, ln2_scale, ln2_bias, ln2_epsilon)
    return out


@_takes_tensor
def fused_softmax_mask(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis (``x [B, H, S, S]``,
    ``mask [B, 1, S, S]``)."""
    return torch.softmax(x + mask, dim=-1)


@_takes_tensor
def fused_softmax_mask_upper_triangle(x, name=None):
    """The causal softmax of the trailing ``[S, S]`` scores: the strict
    upper triangle filled with the type's lowest value before the
    softmax and zeroed after it, as the reference does."""
    s = x.shape[-1]
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    dt = x.dtype if x.is_floating_point() else torch.float32
    neg = torch.full((), torch.finfo(dt).min, dtype=x.dtype, device=x.device)
    out = torch.softmax(torch.where(keep, x, neg), dim=-1)
    return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def _cache_write(cache, k, v, time_step):
    """``cache [2, B, H, T, hd]`` with k and v (``[B, s, H, hd]``) written
    at rows ``time_step ..`` of T, in a new tensor. The start is clamped
    to ``[0, T - s]`` as ``jax.lax.dynamic_update_slice`` clamps it; it
    may be a tensor on the card (no host read)."""
    t_max, s = cache.shape[3], k.shape[1]
    start = torch.as_tensor(time_step).to(cache.device, torch.long)
    start = start.reshape(()).clamp(0, t_max - s)
    rows = start + torch.arange(s, device=cache.device)
    kv = torch.stack([k, v]).transpose(2, 3).to(cache.dtype)
    return cache.index_copy(3, rows, kv)


def _decode_mask(time_step, s, t_max, device):
    """``[1, 1, s, T]`` f32: 0 where key position p <= time_step + row,
    -1e9 elsewhere (the unclamped step, as the reference builds it)."""
    ts = torch.as_tensor(time_step).to(device, torch.long).reshape(())
    pos = torch.arange(t_max, device=device)[None, :]
    row = torch.arange(s, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), -1e9, dtype=torch.float32, device=device)
    return torch.where(pos <= ts + row, zero, neg)[None, None]


def _prefill_mask(s, t_cache, device):
    """``[1, 1, s, t_cache + s]`` f32: the chunk sees the whole cache and
    is causal within itself (-1e9 above the chunk's diagonal)."""
    m = np.full((s, t_cache + s), 0.0, np.float32)
    m[:, t_cache:] = np.triu(np.full((s, s), -1e9, np.float32), 1)
    return torch.from_numpy(m[None, None]).to(device)


def _item(seq, i):
    return None if seq is None else seq[i]


@_takes_tensor
def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, num_heads=None,
                            pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, time_step=None,
                            attn_mask=None, dropout_rate=0.0,
                            activation="gelu", training=False,
                            mode="upscale_in_train",
                            trans_qkvw=True, ring_id=-1, name=None):
    """A stack of fused transformer layers (``functional.py:203-361`` of
    the reference), one per entry of the weight lists.

    ``num_heads`` is required (flat qkv weights cannot encode it).
    ``trans_qkvw``: the qkv weight is ``[3 d, d]`` (else ``[d, 3 d]``).
    Without ``cache_kvs`` the attention is causal (K4a) unless
    ``attn_mask`` is given. With ``cache_kvs`` (one ``[2, B, H, T, hd]``
    a layer) returns ``(out, new caches)``: without ``time_step`` the
    cache grows by the chunk (which sees the cache and is causal within
    itself unless ``attn_mask`` is given); with ``time_step`` the cache
    keeps its shape, the chunk is written at rows ``time_step ..``
    (clamped to fit), and the chunk's row r sees keys up to ``time_step +
    r``, plus ``attn_mask`` when given. Dropout (``dropout_rate`` while
    training) follows the attention's and the FFN's output projections."""
    if num_heads is None:
        raise ValueError(
            "fused_multi_transformer needs num_heads explicitly (flat qkv "
            "weights cannot encode the head count)")
    out = x
    new_caches = [] if cache_kvs is not None else None
    shared_mask = None
    for i in range(len(qkv_weights)):
        residual = out
        d = out.shape[-1]
        h = F.layer_norm(out, d, ln_scales[i], ln_biases[i], epsilon) \
            if pre_layer_norm else out
        w = qkv_weights[i]
        qkv = _add(h @ (_swap_last(w) if trans_qkvw else w),
                   _item(qkv_biases, i))
        b, s = h.shape[0], h.shape[1]
        q, k, v = qkv.reshape(b, s, 3, num_heads, d // num_heads).unbind(2)
        layer_mask, causal = attn_mask, False
        if cache_kvs is not None and time_step is not None:
            cache = _cache_write(cache_kvs[i], k, v, time_step)
            new_caches.append(cache)
            k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
            if shared_mask is None:
                shared_mask = _decode_mask(time_step, s, cache.shape[3],
                                           out.device)
                if attn_mask is not None:
                    shared_mask = shared_mask + attn_mask
            layer_mask = shared_mask
        elif cache_kvs is not None:
            cache = cache_kvs[i]
            t_cache = cache.shape[3]
            k = torch.cat([cache[0].transpose(1, 2), k], dim=1)
            v = torch.cat([cache[1].transpose(1, 2), v], dim=1)
            new_caches.append(torch.stack([k.transpose(1, 2),
                                           v.transpose(1, 2)]))
            if layer_mask is None and s > 1:
                if shared_mask is None:
                    shared_mask = _prefill_mask(s, t_cache, out.device)
                layer_mask = shared_mask
        else:
            causal = layer_mask is None
        att = F.scaled_dot_product_attention(q, k, v, attn_mask=layer_mask,
                                             is_causal=causal,
                                             training=training)
        att = _add(att.reshape(b, s, d) @ linear_weights[i],
                   _item(linear_biases, i))
        if dropout_rate and training:
            att = F.dropout(att, p=dropout_rate, training=True, mode=mode)
        out = residual + att
        if not pre_layer_norm:
            out = F.layer_norm(out, d, ln_scales[i], ln_biases[i], epsilon)
        residual = out
        h = F.layer_norm(out, d, ffn_ln_scales[i], ffn_ln_biases[i],
                         epsilon) if pre_layer_norm else out
        h = _add(h @ ffn1_weights[i], _item(ffn1_biases, i))
        h = F.gelu(h) if activation == "gelu" else F.relu(h)
        h = _add(h @ ffn2_weights[i], _item(ffn2_biases, i))
        if dropout_rate and training:
            h = F.dropout(h, p=dropout_rate, training=True, mode=mode)
        out = residual + h
        if not pre_layer_norm:
            out = F.layer_norm(out, d, ffn_ln_scales[i], ffn_ln_biases[i],
                               epsilon)
    if cache_kvs is not None:
        return out, new_caches
    return out


def _top_columns(scores, c):
    """The ``c`` largest of each row of ``scores`` and their columns,
    the lower column first among equal scores (``jax.lax.top_k``'s
    order; a stable descending sort gives it on any device)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :c], idx[:, :c]


@_takes_tensor
def fused_ec_moe(x, gate, w1, b1, w2, b2, act_type="gelu"):
    """Expert-choice MoE: each of the E experts takes its ``max(1, T //
    E)`` top-scoring tokens (softmax over the experts), runs its FFN
    (``act_type`` gelu, the tanh form, or relu) on them, and adds the
    outputs, weighted by the scores, back to their tokens. ``gate`` is
    the gate weight ``[hidden, E]`` or the gate logits ``[B, S, E]``."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    n_exp = w1.shape[0]
    cap = max(1, t // n_exp)
    logits = gate.reshape(t, n_exp) if gate.dim() == 3 else xf @ gate
    scores = torch.softmax(logits, dim=-1)            # [T, E]
    topv, topi = _top_columns(scores.t(), cap)        # [E, C]
    h = torch.einsum("ecd,edh->ech", xf[topi], w1) + b1
    h = tf.gelu(h, approximate="tanh") if act_type == "gelu" else tf.relu(h)
    o = (torch.einsum("ech,ehd->ecd", h, w2) + b2) * topv[..., None]
    out = torch.zeros_like(xf).index_add(0, topi.reshape(-1),
                                         o.reshape(-1, d))
    return out.reshape(b, s, d)

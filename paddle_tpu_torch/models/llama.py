"""Llama-2 family (RMSNorm pre-norm, RoPE, SwiGLU, GQA).

Port of ``paddle_tpu/models/llama.py``. ``LlamaForCausalLM`` holds its
parameters under the JAX module's names (``model.embed_tokens.weight``,
``model.layers.{i}.self_attn.q_proj.weight``, ..., ``lm_head.weight``)
and its projections and head as ``nn.Linear`` layers with ``[in, out]``
weights, used as ``x @ w`` — so ``models.bridge.load_jax_params`` copies
one model into the other name for name, ``export_params`` back, and
``quantization.to_int8_inference`` swaps those layers for int8 ones. The
full-sequence ``forward()`` (training) runs the JAX module's forwards on
the flash-attention (K4) and RMSNorm (K5) kernels through
``nn.functional`` and rope on K6 (q and k in one launch); serving
runs through the paged decode bundle (``models.generation``) under
``torch.no_grad``.
"""
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layer import Linear, set_state_dict
from ..ops.rope import apply_rotary_qk, precompute_freqs
from .generation import GenerationMixin

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama2_7b", "llama2_70b",
           "llama_350m", "llama_tiny"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = None
    intermediate_size: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tensor_parallel: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


class _Weight(nn.Module):
    """One named, trainable ``weight`` parameter (a norm's scale or the
    embedding table). Serving reads the parameters under
    ``torch.no_grad`` and builds no graph."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device))


class _Proj(Linear):
    """A projection or the head: a bias-free ``Linear`` whose weight
    ``LlamaForCausalLM.reset_parameters`` draws, so building a model
    makes no extra random pass and leaves the global RNG alone."""

    def __init__(self, in_features, out_features, dtype, device):
        super().__init__(in_features, out_features, bias_attr=False,
                         dtype=dtype, device=device)

    def reset_parameters(self):
        pass


class _Attention(nn.Module):
    """``LlamaAttention``: q/k/v projections, rope at rows 0..S-1 (or
    ``position_ids``), kv heads repeated for GQA before the kernel,
    causal SDPA (K4) and the output projection."""

    def __init__(self, cfg, dtype, device, rope):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim
        q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.cfg = cfg
        self.q_proj = _Proj(h, q_out, dtype, device)
        self.k_proj = _Proj(h, kv_out, dtype, device)
        self.v_proj = _Proj(h, kv_out, dtype, device)
        self.o_proj = _Proj(q_out, h, dtype, device)
        # f32 tables shared by every layer: the JAX module's rope buffers
        # are not parameters, and model.astype leaves them in f32
        self.register_buffer("rope_cos", rope[0], persistent=False)
        self.register_buffer("rope_sin", rope[1], persistent=False)

    def forward(self, x, position_ids=None):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, kvh, hd)
        v = self.v_proj(x).reshape(b, s, kvh, hd)
        q, k = apply_rotary_qk(q, k, self.rope_cos, self.rope_sin,
                               position_ids)
        if kvh != nh:
            k = k.repeat_interleave(nh // kvh, dim=2)
            v = v.repeat_interleave(nh // kvh, dim=2)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, nh * hd))


class _MLP(nn.Module):
    """``LlamaMLP``: SwiGLU."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _Proj(h, m, dtype, device)
        self.up_proj = _Proj(h, m, dtype, device)
        self.down_proj = _Proj(m, h, dtype, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _Block(nn.Module):
    """``LlamaBlock``: pre-norm attention and MLP, each with a residual
    (RMSNorm through K5)."""

    def __init__(self, cfg, dtype, device, rope):
        super().__init__()
        self.eps = cfg.rms_eps
        self.input_layernorm = _Weight((cfg.hidden_size,), dtype, device)
        self.self_attn = _Attention(cfg, dtype, device, rope)
        self.post_attention_layernorm = _Weight((cfg.hidden_size,), dtype,
                                                device)
        self.mlp = _MLP(cfg, dtype, device)

    def forward(self, x, position_ids=None):
        x = x + self.self_attn(
            F.rms_norm(x, self.input_layernorm.weight, self.eps),
            position_ids)
        return x + self.mlp(
            F.rms_norm(x, self.post_attention_layernorm.weight, self.eps))


class _Model(nn.Module):
    """``LlamaModel``: embedding, the blocks, the final RMSNorm."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.eps = cfg.rms_eps
        rope = precompute_freqs(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=device)
        self.embed_tokens = _Weight((cfg.vocab_size, cfg.hidden_size),
                                    dtype, device)
        self.layers = nn.ModuleList([_Block(cfg, dtype, device, rope)
                                     for _ in range(cfg.num_layers)])
        self.norm = _Weight((cfg.hidden_size,), dtype, device)

    def forward(self, input_ids, position_ids=None):
        x = F.embedding(input_ids, self.embed_tokens.weight)
        for blk in self.layers:
            x = blk(x, position_ids)
        return F.rms_norm(x, self.norm.weight, self.eps)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """Llama causal LM: ``forward``/``loss`` for training, the paged
    decode bundle for serving.

    ``device=None`` means the CUDA card (raises without one; pass
    ``device="cpu"`` for the plain PyTorch versions). ``dtype`` defaults
    to ``cfg.dtype``. Weights are drawn from a ``torch.Generator`` on the
    model's device seeded with ``seed``: the embedding N(0, 0.02) as in
    the JAX model, Linear weights U(-1/sqrt(in), 1/sqrt(in)), norm scales
    1. The same seed gives the same weights on the same device type;
    tests that compare with the JAX model copy its weights in with
    ``models.bridge.load_jax_params`` instead."""

    def __init__(self, cfg, device=None, dtype=None, seed=0):
        super().__init__()
        if cfg.tensor_parallel:
            raise NotImplementedError(
                "tensor_parallel serving is not ported yet (ROADMAP, "
                "Queue 1 item 9: the fleet)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
        self.model = _Model(cfg, self.dtype, self.device)
        self.lm_head = _Proj(cfg.hidden_size, cfg.vocab_size, self.dtype,
                             self.device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Redraw every weight from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):          # every RMSNorm scale
                p.fill_(1.0)
            elif name == "model.embed_tokens.weight":
                p.normal_(0.0, 0.02, generator=gen)
            else:
                bound = 1.0 / math.sqrt(p.shape[0])
                p.uniform_(-bound, bound, generator=gen)

    def forward(self, input_ids, position_ids=None, return_hidden=False):
        """Logits ``[B, S, vocab]`` in the model's dtype for ``input_ids``
        ``[B, S]`` (a tensor or an array; moved to the model's device),
        or the final hidden states with ``return_hidden=True``."""
        ids = torch.as_tensor(input_ids, device=self.device)
        if position_ids is not None:
            position_ids = torch.as_tensor(position_ids, device=self.device)
        h = self.model(ids, position_ids)
        if return_hidden:
            return h
        return self.lm_head(h)

    def loss(self, logits, labels):
        """Mean next-token cross-entropy in f32: position t predicts
        ``labels[:, t + 1]``."""
        labels = torch.as_tensor(labels, device=logits.device)
        return F.cross_entropy(logits[:, :-1, :], labels[:, 1:])

    set_state_dict = set_state_dict

    def pipeline_decompose(self):
        raise NotImplementedError(
            "pipeline_decompose is not ported (ROADMAP, Queue 1 item 13: "
            "multi-card training, parallel/)")


def llama2_7b(**kw):
    return LlamaConfig(**kw)


def llama2_70b(**kw):
    kw.setdefault("hidden_size", 8192)
    kw.setdefault("num_layers", 80)
    kw.setdefault("num_heads", 64)
    kw.setdefault("num_kv_heads", 8)
    kw.setdefault("intermediate_size", 28672)
    return LlamaConfig(**kw)


def llama_350m(**kw):
    kw.setdefault("hidden_size", 1024)
    kw.setdefault("num_layers", 24)
    kw.setdefault("num_heads", 16)
    kw.setdefault("intermediate_size", 2816)
    kw.setdefault("max_seq_len", 2048)
    return LlamaConfig(**kw)


def llama_tiny(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_kv_heads", 2)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_seq_len", 128)
    return LlamaConfig(**kw)

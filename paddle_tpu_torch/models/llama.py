"""Llama-2 family (RMSNorm pre-norm, RoPE, SwiGLU, GQA) for serving.

Port of ``paddle_tpu/models/llama.py``'s configuration and parameter
layout. ``LlamaForCausalLM`` holds its parameters under the JAX
module's names (``model.embed_tokens.weight``,
``model.layers.{i}.self_attn.q_proj.weight``, ..., ``lm_head.weight``)
and its Linear weights as ``[in, out]``, used as ``x @ w`` — so
``models.bridge.load_jax_params`` copies one model into the other name
for name. Serving runs through the paged decode bundle
(``models.generation``); the full-sequence ``forward()`` rides the
flash-attention and RMSNorm kernels in the JAX package and comes with
the training slice (ROADMAP, Queue 1 item 1).
"""
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
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
    """One named ``weight`` parameter (a Linear's ``[in, out]`` matrix,
    a norm's scale or the embedding table). Serving needs no autograd,
    so parameters are created with ``requires_grad=False``."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False)


class _Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim
        q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.q_proj = _Weight((h, q_out), dtype, device)
        self.k_proj = _Weight((h, kv_out), dtype, device)
        self.v_proj = _Weight((h, kv_out), dtype, device)
        self.o_proj = _Weight((q_out, h), dtype, device)


class _MLP(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _Weight((h, m), dtype, device)
        self.up_proj = _Weight((h, m), dtype, device)
        self.down_proj = _Weight((m, h), dtype, device)


class _Block(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.input_layernorm = _Weight((cfg.hidden_size,), dtype, device)
        self.self_attn = _Attention(cfg, dtype, device)
        self.post_attention_layernorm = _Weight((cfg.hidden_size,), dtype,
                                                device)
        self.mlp = _MLP(cfg, dtype, device)


class _Model(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.embed_tokens = _Weight((cfg.vocab_size, cfg.hidden_size),
                                    dtype, device)
        self.layers = nn.ModuleList([_Block(cfg, dtype, device)
                                     for _ in range(cfg.num_layers)])
        self.norm = _Weight((cfg.hidden_size,), dtype, device)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """Llama causal LM for paged serving.

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
        self.lm_head = _Weight((cfg.hidden_size, cfg.vocab_size), self.dtype,
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

    def forward(self, input_ids, position_ids=None):
        raise NotImplementedError(
            "the full-sequence forward rides the flash-attention and "
            "RMSNorm kernels, which come with the training slice (ROADMAP, "
            "Queue 1 item 1); serve through inference."
            "ContinuousBatchingServer")


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

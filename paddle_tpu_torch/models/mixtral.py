"""Mixtral / DeepSeek-MoE family: the Llama backbone with a routed SwiGLU
expert FFN (top-k gating).

Port of ``paddle_tpu/models/mixtral.py``. ``MixtralForCausalLM`` holds
its parameters under the JAX module's names and shapes: the Llama
attention's (``model.layers.{i}.self_attn.q_proj.weight``, ...), the
router ``model.layers.{i}.moe.gate.gate.weight`` ``[H, E]`` and the
stacked experts ``moe.experts.w_gate`` / ``w_up`` ``[E, H, F]`` and
``w_down`` ``[E, F, H]`` (the reference's ``MoELayer`` over
``ExpertSwiGLU``), so ``models.bridge`` copies one model into the other
name for name. Serving runs through the decode bundles of
``models.generation`` (``_moe_topk_ffn``: every expert runs and each
token combines its top-k normalised gates, as the reference's decode
does). Training runs the reference's eager ``forward`` / ``loss``: the
Llama attention (K6 rope, K4 flash attention), RMSNorm on K5, and each
block's ``parallel.moe.MoELayer`` (the GShard gate's capacity dispatch
over ``moe_group_size`` tokens a group, the stacked SwiGLU experts, the
load-balance aux loss); ``loss`` is the next-token cross-entropy plus
``aux_loss_coef`` times the layers' aux losses.
"""
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layer import set_state_dict
from ..ops.rope import precompute_freqs
from ..parallel.moe import ExpertSwiGLU, GShardGate, MoELayer
from .generation import GenerationMixin
from .llama import LlamaConfig, _Attention, _Embedding, _Proj, _RMSNorm, \
    _Weight

__all__ = ["MixtralConfig", "MixtralBlock", "MixtralModel",
           "MixtralForCausalLM", "mixtral_8x7b", "moe_350m_8e",
           "mixtral_tiny"]


@dataclass
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    moe_group_size: int = None   # tokens per dispatch group; None = seq len

    @property
    def active_params_ratio(self):
        """Fraction of expert params active per token (for MFU accounting)."""
        return self.top_k / self.num_experts


class MixtralBlock(nn.Module):
    """Pre-RMSNorm Llama attention and the routed expert FFN
    (``MoELayer``: the experts, then the router, the reference's
    registration order), each with a residual."""

    def __init__(self, cfg, dtype, device, rope):
        super().__init__()
        self.eps = cfg.rms_eps
        self.input_layernorm = _Weight((cfg.hidden_size,), dtype, device)
        self.self_attn = _Attention(cfg, dtype, device, rope)
        self.post_attention_layernorm = _Weight((cfg.hidden_size,), dtype,
                                                device)
        # undrawn: the model draws every weight
        self.moe = MoELayer(
            cfg.hidden_size,
            experts=ExpertSwiGLU(cfg.num_experts, cfg.hidden_size,
                                 cfg.intermediate_size, dtype=dtype,
                                 device=device, draw=False),
            gate=GShardGate(cfg.hidden_size, cfg.num_experts, cfg.top_k,
                            cfg.capacity_factor, dtype=dtype, device=device,
                            draw=False),
            group_size=cfg.moe_group_size or cfg.max_seq_len)

    def forward(self, x, position_ids=None):
        x = x + self.self_attn(
            F.rms_norm(x, self.input_layernorm.weight, self.eps),
            position_ids)
        return x + self.moe(
            F.rms_norm(x, self.post_attention_layernorm.weight, self.eps))


class MixtralModel(nn.Module):
    """Embedding, the blocks, the final RMSNorm."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        rope = precompute_freqs(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=device)
        self.embed_tokens = _Embedding((cfg.vocab_size, cfg.hidden_size),
                                       dtype, device)
        self.layers = nn.ModuleList([MixtralBlock(cfg, dtype, device, rope)
                                     for _ in range(cfg.num_layers)])
        self.norm = _RMSNorm((cfg.hidden_size,), cfg.rms_eps, dtype, device)

    def forward(self, input_ids, position_ids=None):
        x = self.embed_tokens(input_ids)
        for blk in self.layers:
            x = blk(x, position_ids)
        return self.norm(x)


class MixtralForCausalLM(nn.Module, GenerationMixin):
    """Mixtral causal LM: ``forward`` / ``loss`` for training, the decode
    bundles for serving and ``generate()``.

    ``device=None`` means the CUDA card (pass ``device="cpu"`` for the
    plain PyTorch versions); ``dtype`` defaults to ``cfg.dtype``. Weights
    are drawn from a ``torch.Generator`` on the model's device seeded
    with ``seed``, from the reference's distributions: the embedding
    N(0, 0.02), every projection, router and expert tensor Xavier-normal
    (std ``sqrt(2 / (fan_in + fan_out))``, the fans of a stacked expert
    tensor ``[E, a, b]`` being ``a * b`` and ``E * b``), norm scales 1."""

    def __init__(self, cfg, device=None, dtype=None, seed=0):
        super().__init__()
        if cfg.tensor_parallel:
            raise NotImplementedError(
                "tensor_parallel is not ported yet (ROADMAP, Queue 1 item "
                "9: mesh= and tensor_parallel)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
        self.model = MixtralModel(cfg, self.dtype, self.device)
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
                fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(p)
                p.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                          generator=gen)

    def forward(self, input_ids, position_ids=None):
        """Logits ``[B, S, vocab]`` in the model's dtype for ``input_ids``
        ``[B, S]`` (moved to the model's device); each block's MoE layer
        keeps its aux loss for ``loss``."""
        ids = torch.as_tensor(input_ids, device=self.device)
        if position_ids is not None:
            position_ids = torch.as_tensor(position_ids, device=self.device)
        return self.lm_head(self.model(ids, position_ids))

    def collect_aux_loss(self):
        """Sum of the per-layer load-balance losses of the last forward
        (None before one)."""
        total = None
        for blk in self.model.layers:
            a = blk.moe.aux_loss
            if a is None:
                continue
            total = a if total is None else total + a
        return total

    def loss(self, logits, labels):
        """Mean next-token cross-entropy in f32 plus ``aux_loss_coef``
        times the last forward's aux losses."""
        labels = torch.as_tensor(labels, device=logits.device)
        ce = F.cross_entropy(logits[:, :-1, :], labels[:, 1:])
        aux = self.collect_aux_loss()
        if aux is not None:
            ce = ce + self.cfg.aux_loss_coef * aux
        return ce

    set_state_dict = set_state_dict


def mixtral_8x7b(**kw):
    kw.setdefault("hidden_size", 4096)
    kw.setdefault("num_layers", 32)
    kw.setdefault("num_heads", 32)
    kw.setdefault("num_kv_heads", 8)
    kw.setdefault("intermediate_size", 14336)
    kw.setdefault("num_experts", 8)
    kw.setdefault("top_k", 2)
    return MixtralConfig(**kw)


def moe_350m_8e(**kw):
    """Single-card MoE config: ~190M active / ~530M total params."""
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("hidden_size", 768)
    kw.setdefault("num_layers", 12)
    kw.setdefault("num_heads", 12)
    kw.setdefault("intermediate_size", 2048)
    kw.setdefault("max_seq_len", 1024)
    kw.setdefault("num_experts", 8)
    kw.setdefault("top_k", 2)
    return MixtralConfig(**kw)


def mixtral_tiny(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_kv_heads", 2)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("num_experts", 4)
    kw.setdefault("top_k", 2)
    return MixtralConfig(**kw)

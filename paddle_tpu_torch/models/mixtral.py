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
does). The eager ``forward``/``loss`` of the reference go through the
GShard capacity dispatch and the aux loss of its ``parallel/moe``, the
training path: they raise here (ROADMAP Queue 1 item 13).
"""
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn.layer import set_state_dict
from ..ops.rope import precompute_freqs
from .generation import GenerationMixin
from .llama import LlamaConfig, _Attention, _Proj, _Weight

__all__ = ["MixtralConfig", "MixtralBlock", "MixtralModel",
           "MixtralForCausalLM", "mixtral_8x7b", "moe_350m_8e",
           "mixtral_tiny"]


@dataclass
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2


class _Router(nn.Module):
    """The gate's linear map ``gate.weight`` ``[H, E]``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.gate = _Proj(cfg.hidden_size, cfg.num_experts, dtype, device)


class _Experts(nn.Module):
    """``ExpertSwiGLU``'s stacked weights: ``w_gate``, ``w_up`` ``[E, H,
    F]`` and ``w_down`` ``[E, F, H]``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        E, h, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        for name, shape in (("w_gate", (E, h, f)), ("w_up", (E, h, f)),
                            ("w_down", (E, f, h))):
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))


class _MoE(nn.Module):
    """``MoELayer``'s parameters: the experts, then the router (the
    reference's registration order)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.experts = _Experts(cfg, dtype, device)
        self.gate = _Router(cfg, dtype, device)


class MixtralBlock(nn.Module):
    """Pre-RMSNorm Llama attention and the routed expert FFN."""

    def __init__(self, cfg, dtype, device, rope):
        super().__init__()
        self.input_layernorm = _Weight((cfg.hidden_size,), dtype, device)
        self.self_attn = _Attention(cfg, dtype, device, rope)
        self.post_attention_layernorm = _Weight((cfg.hidden_size,), dtype,
                                                device)
        self.moe = _MoE(cfg, dtype, device)


class MixtralModel(nn.Module):
    """Embedding, the blocks, the final RMSNorm."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        rope = precompute_freqs(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=device)
        self.embed_tokens = _Weight((cfg.vocab_size, cfg.hidden_size),
                                    dtype, device)
        self.layers = nn.ModuleList([MixtralBlock(cfg, dtype, device, rope)
                                     for _ in range(cfg.num_layers)])
        self.norm = _Weight((cfg.hidden_size,), dtype, device)


class MixtralForCausalLM(nn.Module, GenerationMixin):
    """Mixtral causal LM: the decode bundles for serving and
    ``generate()``; ``forward`` and ``loss`` raise (ROADMAP Queue 1
    item 13: the capacity dispatch of ``parallel/moe``).

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
        raise NotImplementedError(
            "MixtralForCausalLM.forward (the GShard capacity dispatch and "
            "aux loss of parallel/moe) is not ported (ROADMAP, Queue 1 "
            "item 13: multi-card training, moe); serve it through "
            "generate() or ContinuousBatchingServer")

    def loss(self, logits, labels):
        raise NotImplementedError(
            "MixtralForCausalLM.loss (cross-entropy plus the moe aux loss) "
            "is not ported (ROADMAP, Queue 1 item 13: multi-card "
            "training, moe)")

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

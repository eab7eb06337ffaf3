"""GPT-2/3 family (decoder-only, learned positions, LayerNorm + GELU).

Port of ``paddle_tpu/models/gpt.py``. ``GPTForCausalLM`` holds its
parameters under the JAX module's names (``gpt.wpe.weight``,
``gpt.blocks.{i}.attn.qkv.weight``, ..., ``gpt.ln_f.bias``) with the
head tied to the token table, as in the reference: ``lm_head_weight``
IS ``gpt.wte.weight``. Both packages list a tied parameter once, under
the name it has on the module that owns it first (the root), so the
table crosses ``models.bridge`` as ``lm_head_weight``. ``forward`` and
``loss`` are the eager oracle (attention through
``nn.functional.scaled_dot_product_attention``: K4 on the card);
serving runs through the decode bundles of ``models.generation``.
"""
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layer import set_state_dict
from ..nn.layers_basic import Embedding, LayerNorm, Linear
from .generation import GenerationMixin

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt2_345m", "gpt2_tiny"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    max_seq_len: int = 1024
    intermediate_size: int = None
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    tensor_parallel: bool = False

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size


class _Linear(Linear):
    """A projection with a bias whose weight ``GPTForCausalLM.
    reset_parameters`` draws (no extra random pass at construction)."""

    # the reference builds it as a plain nn.Linear: QAT swaps it as one
    _reference_type = Linear

    def reset_parameters(self):
        pass


class _Table(Embedding):
    """An embedding table ``GPTForCausalLM.reset_parameters`` draws."""

    def reset_parameters(self, generator=None):
        pass


def _dropout(x, p, training):
    return F.dropout(x, p=p, training=training) if p > 0.0 else x


class GPTAttention(nn.Module):
    """Fused qkv projection, causal SDPA over ``num_heads`` heads (MHA),
    the output projection, dropout."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv = _Linear(h, 3 * h, dtype=dtype, device=device)
        self.proj = _Linear(h, h, dtype=dtype, device=device)

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        nh = self.cfg.num_heads
        hd = self.cfg.hidden_size // nh
        q, k, v = self.qkv(x).reshape(b, s, 3, nh, hd).unbind(2)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             training=self.training)
        out = self.proj(out.reshape(b, s, nh * hd))
        return _dropout(out, self.cfg.dropout, self.training)


class GPTMLP(nn.Module):
    """fc1, tanh GELU, fc2, dropout."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.fc1 = _Linear(h, m, dtype=dtype, device=device)
        self.fc2 = _Linear(m, h, dtype=dtype, device=device)

    def forward(self, x):
        out = self.fc2(F.gelu(self.fc1(x), approximate=True))
        return _dropout(out, self.cfg.dropout, self.training)


class GPTBlock(nn.Module):
    """Pre-LayerNorm attention and MLP, each with a residual."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=eps, dtype=dtype,
                             device=device)
        self.attn = GPTAttention(cfg, dtype, device)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=eps, dtype=dtype,
                             device=device)
        self.mlp = GPTMLP(cfg, dtype, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPTModel(nn.Module):
    """Token and learned position embeddings, the blocks, the final
    LayerNorm."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.wte = _Table(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                          device=device)
        self.wpe = _Table(cfg.max_seq_len, cfg.hidden_size, dtype=dtype,
                          device=device)
        self.blocks = nn.ModuleList([GPTBlock(cfg, dtype, device)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              dtype=dtype, device=device)

    def forward(self, input_ids, position_ids=None):
        s = input_ids.shape[-1]
        if position_ids is None:
            position_ids = torch.arange(s, dtype=torch.int32,
                                        device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(position_ids)
        x = _dropout(x, self.cfg.dropout, self.training)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT causal LM with the head tied to the token table.

    ``device=None`` means the CUDA card (pass ``device="cpu"`` for the
    plain PyTorch versions); ``dtype`` defaults to float32. Weights are
    drawn from a ``torch.Generator`` on the model's device seeded with
    ``seed``, from the reference's distributions: the two embedding
    tables N(0, 0.02), Linear weights Xavier-normal (std ``sqrt(2 / (in
    + out))``), biases 0, LayerNorms 1 and 0. Tests that compare with
    the JAX model copy its weights in with
    ``models.bridge.load_jax_params``. ``tensor_parallel`` (ROADMAP
    Queue 1 item 9) and ``pipeline_decompose`` (item 13) raise."""

    def __init__(self, cfg, device=None, dtype=None, seed=0):
        super().__init__()
        if cfg.tensor_parallel:
            raise NotImplementedError(
                "tensor_parallel is not ported yet (ROADMAP, Queue 1 item "
                "9: mesh= and tensor_parallel)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch.float32 if dtype is None else dtype
        self.gpt = GPTModel(cfg, self.dtype, self.device)
        self.lm_head_weight = self.gpt.wte.weight           # tied, [V, H]
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Redraw every weight from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name in ("lm_head_weight", "gpt.wpe.weight"):
                p.normal_(0.0, 0.02, generator=gen)
            elif ".ln" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, math.sqrt(2.0 / sum(p.shape)),
                          generator=gen)

    def forward(self, input_ids, position_ids=None, return_hidden=False):
        """Logits ``[B, S, vocab]`` in the model's dtype (the hidden
        states times the tied table, transposed), or the final hidden
        states with ``return_hidden=True``."""
        ids = torch.as_tensor(input_ids, device=self.device)
        if position_ids is not None:
            position_ids = torch.as_tensor(position_ids, device=self.device)
        h = self.gpt(ids, position_ids)
        if return_hidden:
            return h
        return torch.matmul(h, self.lm_head_weight.t())

    def loss(self, logits, labels):
        """Mean next-token cross-entropy in f32."""
        labels = torch.as_tensor(labels, device=logits.device)
        return F.cross_entropy(logits[:, :-1, :], labels[:, 1:])

    set_state_dict = set_state_dict

    def pipeline_decompose(self):
        raise NotImplementedError(
            "pipeline_decompose is not ported (ROADMAP, Queue 1 item 13: "
            "multi-card training, parallel/)")


def gpt2_345m(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                     num_heads=16, max_seq_len=1024, **kw)


def gpt2_tiny(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_seq_len", 128)
    return GPTConfig(**kw)

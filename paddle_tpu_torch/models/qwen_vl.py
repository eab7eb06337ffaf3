"""Qwen-VL-style vision-language model: port of
``paddle_tpu/models/qwen_vl.py``.

A ViT tower (patch embedding, pre-norm blocks) -> a linear projector ->
visual tokens prepended to the token embeddings of a Llama backbone
(``models.llama.LlamaModel``; rope positions 0..S-1 over the joint
sequence). The loss slices the visual prefix off and scores the text
targets only. Every parameter keeps the JAX module's name
(``visual.*``, ``projector.*``, ``language_model.*``, ``lm_head.*``), so
``models.bridge.load_jax_params`` carries a model across name for name.

On the card the ViT's attention (no mask, no dropout) runs the
flash-attention kernels (K4a forward, K4b backward) once a block; the
text tower runs K4 (causal), RMSNorm (K5: two a block and the final one)
and rope (K6: q and k in one launch a block), as ``LlamaForCausalLM``'s
forward does. ``generate`` prefills the joint sequence through the
dense decode functions of ``models.generation`` (a view holding
``cfg``, ``model`` and ``lm_head``, as the reference builds one) and
decodes with ``inference.decode_loop``'s greedy or seeded-sampled loop.

``QwenVL(cfg, device=None, dtype=None)``: every weight is the JAX
module's draw from the global key (``seed()``), in its order: the ViT,
the projector, the backbone (``LlamaModel``), the head. ``device`` None
is the default place (the card unless ``set_device`` chose another),
``dtype`` None float32 (the backbone is built in ``dtype`` directly,
the rest cast after drawing; each weight is drawn in f32).
"""
import types
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import nn
from ..core import prng
from ..core.dtype import canonical, convert_dtype
from ..device import default_device, default_place
from ..nn import functional as F
from ..nn.initializer import Normal
from ._stem import patches_to_seq, shard_params_by_name
from .llama import LlamaConfig, LlamaModel

__all__ = ["ViTConfig", "VisionTransformer", "QwenVLConfig", "QwenVL",
           "qwen_vl_tiny"]


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    in_channels: int = 3
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


class ViTBlock(nn.Layer):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(h)
        self.qkv = nn.Linear(h, 3 * h)
        self.proj = nn.Linear(h, h)
        self.norm2 = nn.LayerNorm(h)
        m = int(h * cfg.mlp_ratio)
        self.mlp = nn.Sequential(nn.Linear(h, m), nn.GELU(approximate=True),
                                 nn.Linear(m, h))

    def forward(self, x):
        b, s, h = x.shape
        hd = h // self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(b, s, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = F.scaled_dot_product_attention(q, k, v, is_causal=False,
                                             training=self.training)
        x = x + self.proj(att.reshape(b, s, h))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Layer):
    """Pre-norm ViT returning the patch tokens ``[B, T_img, D_vit]`` (no
    CLS pooling: the projector takes the whole grid)."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        with default_place(device):
            self.patch_embed = nn.Conv2D(cfg.in_channels, cfg.hidden_size,
                                         kernel_size=p, stride=p)
            self.pos_embed = self.create_parameter(
                (1, cfg.num_patches, cfg.hidden_size),
                default_initializer=Normal(0.0, 0.02))
            self.blocks = nn.LayerList([ViTBlock(cfg)
                                        for _ in range(cfg.num_layers)])
            self.norm = nn.LayerNorm(cfg.hidden_size)

    def forward(self, pixel_values):
        h = patches_to_seq(self.patch_embed(pixel_values)) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        return self.norm(h)


@dataclass
class QwenVLConfig:
    vision: ViTConfig = field(default_factory=ViTConfig)
    text: LlamaConfig = field(default_factory=LlamaConfig)
    ignore_index: int = -100


class QwenVL(nn.Layer):
    def __init__(self, cfg: QwenVLConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        dt = canonical(convert_dtype(dtype)) if dtype is not None \
            else torch.float32
        with default_place(device):
            self.visual = VisionTransformer(cfg.vision)
            self.projector = nn.Linear(cfg.vision.hidden_size,
                                       cfg.text.hidden_size)
            self.language_model = LlamaModel(cfg.text, default_device(), dt)
            self.lm_head = nn.Linear(cfg.text.hidden_size,
                                     cfg.text.vocab_size, bias_attr=False)
        if dt != torch.float32:
            for m in (self.visual, self.projector, self.lm_head):
                m.astype(dt)
            self._dtype = dt

    def forward(self, input_ids, pixel_values=None):
        """input_ids ``[B, S_txt]``; pixel_values ``[B, C, H, W]`` or
        None. The visual tokens (cast to the text embedding's dtype) are
        prepended; returns the logits over the joint sequence."""
        lm = self.language_model
        emb = lm.embed_tokens(input_ids)
        if pixel_values is not None:
            vis = self.projector(self.visual(pixel_values))
            emb = torch.cat([vis.to(emb.dtype), emb], dim=1)
        x = emb
        for blk in lm.layers:
            x = blk(x)
        return self.lm_head(lm.norm(x))

    def loss(self, logits, labels, num_visual_tokens=None):
        """Cross-entropy over the text targets only: the visual prefix is
        sliced off the logits before the next-token shift."""
        labels = torch.as_tensor(labels, device=logits.device)
        if num_visual_tokens is None:
            num_visual_tokens = logits.shape[1] - labels.shape[1]
        if num_visual_tokens > 0:
            logits = logits[:, num_visual_tokens:]
        return F.cross_entropy(logits[:, :-1, :], labels[:, 1:])

    @torch.no_grad()
    def generate(self, input_ids, pixel_values=None, max_new_tokens=32,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 eos_token_id=None, seed=None, max_cache_len=None):
        """Multimodal generation: the visual tokens and the prompt fill
        the dense caches in one prefill step (positions 0..n_vis + T - 1,
        as the training forward), then the text decodes greedily or from
        ``PRNGKey(seed)`` (``seed=None`` draws one from numpy's global
        RNG, as the reference does). Returns the text sequence (prompt +
        ``max_new_tokens``) as int32 on the model's device. The decode
        functions are cached per ``max_cache_len``, at most four, least
        recently used out first."""
        from ..inference.decode_loop import greedy_generate, sample_generate
        from .generation import _make_llama_decode_fns

        if torch.is_tensor(input_ids):
            input_ids = input_ids.detach().cpu().numpy()
        ids_np = np.asarray(input_ids).astype(np.int32)
        if ids_np.ndim == 1:
            ids_np = ids_np[None]
        B, T = ids_np.shape
        lm = self.language_model
        vis = None
        n_vis = 0
        if pixel_values is not None:
            vis = self.projector(self.visual(pixel_values))
            n_vis = vis.shape[1]
        total = n_vis + T
        if max_cache_len is None:
            max_cache_len = min(self.cfg.text.max_seq_len,
                                total + max_new_tokens)
        if total + max_new_tokens > max_cache_len:
            raise ValueError(
                f"visual ({n_vis}) + prompt ({T}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_cache_len "
                f"({max_cache_len})")

        key = ("_pt_vl_bundle", max_cache_len)
        cached = getattr(self, "_pt_decode_cache", None)
        if cached is None:
            cached = self._pt_decode_cache = {}
        fns = cached.pop(key, None)
        if fns is None:
            view = types.SimpleNamespace(
                cfg=self.cfg.text, model=lm, lm_head=self.lm_head,
                device=lm.device, dtype=lm.dtype)
            fns = _make_llama_decode_fns(view, max_cache_len)
        cached[key] = fns                      # LRU: newest at the back
        while len(cached) > 4:                 # bundles pin weight copies
            cached.pop(next(iter(cached)))
        init_caches, embed_fn, step_fn, head_fn = fns

        table = lm.embed_tokens.weight
        x0 = table[torch.from_numpy(ids_np).to(table.device).long()]
        if vis is not None:
            x0 = torch.cat([vis.to(x0.dtype), x0], dim=1)
        caches = init_caches(B)
        out, caches = step_fn(x0, caches, 0)
        last_logits = head_fn(out[:, -1:])[:, -1]

        if do_sample:
            if seed is None:
                seed = int(np.random.randint(0, 2**31))
            new_ids, _ = sample_generate(
                embed_fn, step_fn, head_fn, caches, last_logits, total,
                max_new_tokens, prng.PRNGKey(seed),
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_token_id=eos_token_id)
        else:
            first = torch.argmax(last_logits, -1).to(torch.int32)
            new_ids, _ = greedy_generate(
                embed_fn, step_fn, head_fn, caches, first, total,
                max_new_tokens, eos_token_id=eos_token_id)
        prompt = torch.from_numpy(ids_np).to(new_ids.device)
        return torch.cat([prompt, new_ids], dim=1)


def shard_qwen_vl(model, process_mesh):
    """auto_parallel annotation: raises until item 13 brings it."""
    return shard_params_by_name(model, process_mesh,
                                ("qkv", "mlp", "gate_proj", "up_proj",
                                 "down_proj", "lm_head"))


def qwen_vl_tiny(**kw):
    vis = ViTConfig(image_size=16, patch_size=4, in_channels=3,
                    hidden_size=32, num_layers=2, num_heads=4)
    txt = LlamaConfig(vocab_size=256, hidden_size=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_size=128,
                      max_seq_len=128)
    return QwenVLConfig(vision=vis, text=txt, **kw)

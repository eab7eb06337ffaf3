"""DiT (Diffusion Transformer) with adaLN-Zero conditioning and the DDPM
epsilon-prediction objective: port of ``paddle_tpu/models/dit.py``.

Built from the port's ``nn`` under the JAX module's names. Attention is
``scaled_dot_product_attention`` without a mask or dropout, so it runs
the flash-attention kernels (K4a forward, K4b backward: one launch each
of dq and dkv) once a block; the patch embedding is a ``Conv2D`` with
kernel = stride = patch (cuDNN on the card), and the LayerNorms, the
modulation and ``unpatchify`` are plain torch. The adaLN and final
projections start at zero (``Constant(0)``), so at initialisation every
block is the identity and the model outputs 0. ``DiTForDiffusion``'s
cosine schedule ``alphas_cumprod`` is a constant built on the host in f32
(the same bits on every device), a non-persistent buffer: it is not a
parameter and is not in ``state_dict()``.

The classes take a ``device=`` keyword (None: the default place).
"""
import math
from dataclasses import dataclass

import torch

from .. import nn
from ..device import default_place
from ..nn import functional as F
from ..nn.initializer import Constant, Normal
from ._stem import patches_to_seq, shard_params_by_name

__all__ = ["DiTConfig", "DiT", "DiTForDiffusion", "dit_s_4", "dit_tiny"]


@dataclass
class DiTConfig:
    image_size: int = 32          # latent spatial size
    patch_size: int = 4
    in_channels: int = 4
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    num_classes: int = 1000
    mlp_ratio: float = 4.0
    learn_sigma: bool = False
    dtype: str = "float32"

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def out_channels(self):
        return self.in_channels * (2 if self.learn_sigma else 1)


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal timestep embedding ``[B, dim]`` in f32 (cos, then sin)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class TimestepEmbedder(nn.Layer):
    def __init__(self, hidden_size, freq_dim=256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(
            nn.Linear(freq_dim, hidden_size), nn.SiLU(),
            nn.Linear(hidden_size, hidden_size))

    def forward(self, t):
        return self.mlp(timestep_embedding(t, self.freq_dim))


class LabelEmbedder(nn.Layer):
    """Class conditioning; index ``num_classes`` is the null label."""

    def __init__(self, num_classes, hidden_size):
        super().__init__()
        self.table = nn.Embedding(num_classes + 1, hidden_size)

    def forward(self, y):
        return self.table(y)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Layer):
    """adaLN-Zero block: the conditioning predicts a shift, scale and
    gate for the attention and MLP branches; the gates start at zero."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(h)
        self.norm2 = nn.LayerNorm(h)
        self.qkv = nn.Linear(h, 3 * h)
        self.proj = nn.Linear(h, h)
        m = int(h * cfg.mlp_ratio)
        self.mlp = nn.Sequential(nn.Linear(h, m), nn.GELU(approximate=True),
                                 nn.Linear(m, h))
        self.ada = nn.Linear(h, 6 * h, weight_attr=Constant(0.0),
                             bias_attr=Constant(0.0))

    def _attn(self, x):
        b, s, h = x.shape
        hd = h // self.num_heads
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(q, k, v, is_causal=False,
                                             training=self.training)
        return self.proj(out.reshape(b, s, h))

    def forward(self, x, c):
        mod = self.ada(F.silu(c))
        h = x.shape[-1]
        sh1, sc1, g1, sh2, sc2, g2 = [mod[:, i * h:(i + 1) * h]
                                      for i in range(6)]
        x = x + g1[:, None, :] * self._attn(
            _modulate(self.norm1(x), sh1, sc1))
        x = x + g2[:, None, :] * self.mlp(
            _modulate(self.norm2(x), sh2, sc2))
        return x


class FinalLayer(nn.Layer):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.norm = nn.LayerNorm(h)
        self.ada = nn.Linear(h, 2 * h, weight_attr=Constant(0.0),
                             bias_attr=Constant(0.0))
        self.linear = nn.Linear(
            h, cfg.patch_size * cfg.patch_size * cfg.out_channels,
            weight_attr=Constant(0.0), bias_attr=Constant(0.0))

    def forward(self, x, c):
        mod = self.ada(F.silu(c))
        h = x.shape[-1]
        shift, scale = mod[:, :h], mod[:, h:]
        return self.linear(_modulate(self.norm(x), shift, scale))


class DiT(nn.Layer):
    def __init__(self, cfg: DiTConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        with default_place(device):
            self.patch_embed = nn.Conv2D(cfg.in_channels, cfg.hidden_size,
                                         kernel_size=p, stride=p)
            self.pos_embed = self.create_parameter(
                (1, cfg.num_patches, cfg.hidden_size),
                default_initializer=Normal(0.0, 0.02))
            self.t_embedder = TimestepEmbedder(cfg.hidden_size)
            self.y_embedder = LabelEmbedder(cfg.num_classes,
                                            cfg.hidden_size)
            self.blocks = nn.LayerList([DiTBlock(cfg)
                                        for _ in range(cfg.num_layers)])
            self.final_layer = FinalLayer(cfg)

    def unpatchify(self, x):
        """``[B, T, p * p * C]`` -> ``[B, C, H, W]``."""
        cfg = self.cfg
        p, c = cfg.patch_size, cfg.out_channels
        hw = cfg.image_size // p
        b = x.shape[0]
        x = x.reshape(b, hw, hw, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, c, hw * p, hw * p)

    def forward(self, x, t, y=None):
        """x: ``[B, C, H, W]`` latents; t: ``[B]`` timesteps; y: ``[B]``
        labels."""
        h = patches_to_seq(self.patch_embed(x)) + self.pos_embed
        c = self.t_embedder(t)
        if y is not None:
            c = c + self.y_embedder(y)
        for blk in self.blocks:
            h = blk(h, c)
        return self.unpatchify(self.final_layer(h, c))


class DiTForDiffusion(nn.Layer):
    """DDPM epsilon prediction: cosine alpha-bar schedule, MSE loss."""

    def __init__(self, cfg: DiTConfig, num_train_timesteps=1000, *,
                 device=None):
        super().__init__()
        self.cfg = cfg
        with default_place(device):
            self.dit = DiT(cfg)
        self.num_train_timesteps = num_train_timesteps
        s = 0.008
        steps = torch.arange(num_train_timesteps + 1, dtype=torch.float32)
        f = torch.cos((steps / num_train_timesteps + s) / (1 + s)
                      * math.pi / 2) ** 2
        dev = self.dit.pos_embed.device
        self.register_buffer("alphas_cumprod", (f / f[0])[:-1].to(dev),
                             persistable=False)

    def forward(self, x, t, y=None):
        return self.dit(x, t, y)

    def add_noise(self, x0, noise, t):
        a = self.alphas_cumprod[t.long()][:, None, None, None]
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def loss(self, x0, t, noise, y=None):
        xt = self.add_noise(x0, noise, t)
        pred = self.dit(xt, t, y)
        if self.cfg.learn_sigma:
            pred = pred[:, :self.cfg.in_channels]
        return F.mse_loss(pred, noise)


def shard_dit(model, process_mesh):
    """auto_parallel annotation: raises until item 13 brings it."""
    return shard_params_by_name(model, process_mesh, ("qkv", "mlp"))


def dit_s_4(**kw):
    kw.setdefault("hidden_size", 384)
    kw.setdefault("num_layers", 12)
    kw.setdefault("num_heads", 6)
    kw.setdefault("patch_size", 4)
    return DiTConfig(**kw)


def dit_tiny(**kw):
    kw.setdefault("image_size", 8)
    kw.setdefault("patch_size", 2)
    kw.setdefault("in_channels", 3)
    kw.setdefault("hidden_size", 32)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_classes", 10)
    return DiTConfig(**kw)

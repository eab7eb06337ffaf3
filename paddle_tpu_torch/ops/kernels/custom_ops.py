"""The forward kernels that an exported inference program can meet, as
``torch.library`` custom ops in the ``paddle_tpu_torch`` namespace.

``torch.export`` traces with fake tensors, and a wrapper hands its
kernel raw pointers through ``ctypes``: a fake tensor has none, and a
trace through the wrapper's plain version would record the composition
in place of the kernel. So while a program is being exported
(``torch.compiler.is_exporting()``) the entry points below call these
ops instead, and the exported graph holds one op call where the eager
path launches the kernel:

- ``flash_fwd``: K4a, ``flash_attention.flash_fwd`` (o and lse);
- ``rms_norm_fwd``: K5a, ``rms_norm.rms_norm_fwd``;
- ``rope_fwd`` and ``rope_qk_fwd``: K6, ``rope.rope_fwd`` and
  ``rope.rope_qk_fwd`` (rows 0..S-1);
- ``gemm_epilogue``: K7, ``gemm_epilogue.gemm_epilogue``;
- ``quantized_matmul``: K8 over a K-major weight,
  ``quant_matmul.quantized_matmul_kmajor``.

An op's body is the wrapper itself: a CPU tensor takes the plain
version, a CUDA tensor the kernel or an error, and the wrapper's launch
counter counts. Each op's ``register_fake`` gives its outputs' shapes
and dtypes. The eager routes (the train step, ``generate()``, the
serving tick) call the wrappers directly and never pass through the
dispatcher. Importing ``paddle_tpu_torch.ops.kernels`` registers the
ops, which ``torch.export.load`` needs before it reads an archive that
holds them.

The serving kernels (K1–K3), the backward kernels, the optimizer's step
and the random draws (R1, R2) get no op: no exported program reaches
them.
"""
from typing import Optional

import torch

from . import flash_attention as _fa
from . import gemm_epilogue as _ge
from . import quant_matmul as _qm
from . import rms_norm as _rn
from . import rope as _rp

__all__ = ["NAMESPACE", "flash_fwd", "rms_norm_fwd", "rope_fwd",
           "rope_qk_fwd", "gemm_epilogue", "quantized_matmul"]

NAMESPACE = "paddle_tpu_torch"


@torch.library.custom_op(f"{NAMESPACE}::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float, causal: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4a on ``[batch * heads, S, head_dim]``: (o, lse f32)."""
    return _fa.flash_fwd(q, k, v, sm_scale, causal)


@flash_fwd.register_fake
def _(q, k, v, sm_scale, causal):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


@torch.library.custom_op(f"{NAMESPACE}::rms_norm_fwd", mutates_args=())
def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """K5a: RMSNorm of x's last dim, in x's dtype."""
    return _rn.rms_norm_fwd(x, w, eps)


@rms_norm_fwd.register_fake
def _(x, w, eps):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::rope_fwd", mutates_args=())
def rope_fwd(x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> torch.Tensor:
    """K6 on x ``[B, S, H, D]`` at rows 0..S-1 of the tables."""
    return _rp.rope_fwd(x, cos, sin, 1)


@rope_fwd.register_fake
def _(x, cos, sin):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::rope_qk_fwd", mutates_args=())
def rope_qk_fwd(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 on q and k at the same rows, one launch: (q rotated, k
    rotated)."""
    return _rp.rope_qk_fwd(q, k, cos, sin, 1)


@rope_qk_fwd.register_fake
def _(q, k, cos, sin):
    return torch.empty_like(q), torch.empty_like(k)


@torch.library.custom_op(f"{NAMESPACE}::gemm_epilogue", mutates_args=())
def gemm_epilogue(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  activation: str) -> torch.Tensor:
    """K7: ``act(x @ w + bias)`` for x ``[M, K]``, w ``[K, N]``."""
    return _ge.gemm_epilogue(x, w, bias, activation)


@gemm_epilogue.register_fake
def _(x, w, bias, activation):
    return x.new_empty((x.shape[0], w.shape[1]))


@torch.library.custom_op(f"{NAMESPACE}::quantized_matmul", mutates_args=())
def quantized_matmul(x: torch.Tensor, wt: torch.Tensor,
                     scale_x: torch.Tensor, scale_w: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """K8: int8 x ``[M, K]`` against the K-major int8 wt ``[N, K]``,
    dequantized by ``scale_x`` (0-d) and ``scale_w`` (``[N]`` or a
    scalar), each taken as f32, in ``out_dtype``."""
    return _qm.quantized_matmul_kmajor(x, wt, scale_x, scale_w, out_dtype)


@quantized_matmul.register_fake
def _(x, wt, scale_x, scale_w, out_dtype):
    return x.new_empty((x.shape[0], wt.shape[0]), dtype=out_dtype)

"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

``paddle_tpu`` (JAX/XLA/Pallas) stays the reference; this package does
the same work in PyTorch on an NVIDIA Hopper card, slice by slice. The
slices so far serve the Llama family with paged continuous batching:

- ``models.llama.LlamaForCausalLM`` and its paged decode bundle
  (``models.generation``);
- ``inference.ContinuousBatchingServer`` in paged mode with ragged
  prefill and split or fused ticks, over the host-side page allocator
  and radix prefix cache;
- three hand-written CUDA kernels for ``sm_90a`` under ``csrc/``: paged
  decode attention, ragged prefill attention and fused-tick attention
  (``ops.kernels.paged_attention`` / ``ops.kernels.ragged_prefill`` /
  ``ops.kernels.fused_tick``), each with a plain PyTorch version beside
  it.

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``). On the CPU every kernel wrapper takes its
plain version; a CUDA tensor takes the kernel or raises.

This package imports torch, numpy and the standard library only — never
jax or ``paddle_tpu`` (tests/test_torch_import_hygiene.py).
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]

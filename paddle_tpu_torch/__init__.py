"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

``paddle_tpu`` (JAX/XLA/Pallas) stays the reference; this package does
the same work in PyTorch on an NVIDIA Hopper card, slice by slice. The
slices so far serve the Llama family with paged continuous batching,
train it, and run it in int8:

- ``models.llama.LlamaForCausalLM``: the full-sequence forward and loss
  for training, and its paged decode bundle (``models.generation``);
- ``inference.ContinuousBatchingServer`` in paged mode with ragged
  prefill and split or fused ticks, over the host-side page allocator
  and radix prefix cache;
- ``nn.functional`` (the train step's operators), ``nn.Linear``,
  ``optimizer`` (Adam, AdamW with the JAX update rule) and
  ``jit.train_step_fn``;
- ``quantization.to_int8_inference`` (every ``nn.Linear`` becomes an
  ``Int8InferLinear``) and ``incubate.nn.functional``'s fused linear and
  rope entry points;
- eight hand-written CUDA kernels for ``sm_90a`` under ``csrc/``: paged
  decode attention, ragged prefill attention and fused-tick attention
  for serving (``ops.kernels.paged_attention`` /
  ``ops.kernels.ragged_prefill`` / ``ops.kernels.fused_tick``), flash
  attention and RMSNorm, forward and backward, for training
  (``ops.kernels.flash_attention`` / ``ops.kernels.rms_norm``), rope
  (``ops.kernels.rope``, q and k in one launch, training's rope on the
  card), the fused GEMM + bias + activation
  (``ops.kernels.gemm_epilogue``) and the int8 matmul with its
  dequantize (``ops.kernels.quant_matmul``), each with a plain PyTorch
  version beside it.

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``). On the CPU every kernel wrapper takes its
plain version; a CUDA tensor takes the kernel or raises.

This package imports torch, numpy and the standard library only — never
jax or ``paddle_tpu`` (tests/test_torch_import_hygiene.py).
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]

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
- ``nn.functional`` (the train step's operators, ``cross_entropy``'s
  options, masked attention), ``nn.Linear``, the gradient clips
  (``nn.clip``), the optimizer zoo with the JAX update rules and the
  learning-rate schedulers (``optimizer``, ``optimizer.lr``),
  mixed precision (``amp``: ``auto_cast``, ``decorate``,
  ``GradScaler``), activation recompute (``parallel.recompute_util``)
  and ``jit.train_step_fn``;
- ``quantization.to_int8_inference`` (every ``nn.Linear`` becomes an
  ``Int8InferLinear``) and ``incubate.nn.functional``'s fused linear and
  rope entry points;
- hand-written CUDA kernels for ``sm_90a`` under ``csrc/``, one for each
  TPU kernel: paged
  decode attention, ragged prefill attention and fused-tick attention
  for serving (``ops.kernels.paged_attention`` /
  ``ops.kernels.ragged_prefill`` / ``ops.kernels.fused_tick``), flash
  attention and RMSNorm, forward and backward, for training
  (``ops.kernels.flash_attention`` / ``ops.kernels.rms_norm``), rope
  (``ops.kernels.rope``, q and k in one launch, training's rope on the
  card), the fused GEMM + bias + activation
  (``ops.kernels.gemm_epilogue``) and the int8 matmul with its
  dequantize (``ops.kernels.quant_matmul``), each with a plain PyTorch
  version beside it; and a ninth, the optimizer's fused Adam / AdamW
  step over every live parameter (``ops.kernels.multi_tensor_adam``),
  the counterpart of the reference's jitted multi-tensor update.

The high-level training loop is ``Model`` (``hapi``): ``prepare``,
``fit`` with or without the fault-tolerant ``reliability.
TrainSupervisor`` (durable checkpoints in the reference's format, exact
resume, NaN-step skip and rollback, preemption), ``evaluate``,
``predict``, ``save`` and ``load``, over ``io.DataLoader`` (samplers on
numpy's RNG, fork workers over shared memory) and ``metric``.

Randomness is ``jax.random``'s threefry stream bit for bit
(``core.prng``): ``seed``, ``get_rng_state`` and ``set_rng_state`` hold
the global key (``core.random``), the server samples seeded tokens with
R1 (``ops.kernels.sample_rows``) and dropout and the other draws run on
R2 (``ops.kernels.threefry_fill``).

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``). On the CPU every kernel wrapper takes its
plain version; a CUDA tensor takes the kernel or raises.

This package imports torch, numpy and the standard library only — never
jax or ``paddle_tpu`` (tests/test_torch_import_hygiene.py).
"""
from . import hapi, io, metric, reliability  # noqa: F401
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .device import resolve_device  # noqa: F401
from .hapi import Model, flops, summary  # noqa: F401
from .io import load, save  # noqa: F401

__version__ = "0.1.0"       # the JAX package's, whose API this ports

__all__ = ["resolve_device", "seed", "get_rng_state", "set_rng_state",
           "hapi", "io", "metric", "reliability", "Model", "summary",
           "flops", "save", "load"]

"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built at first
use by ``_build``), each with its plain PyTorch version and a launch
counter on its wrapper: ``paged_attention.paged_attention``,
``ragged_prefill.ragged_prefill_attention``,
``fused_tick.fused_tick_attention``, ``flash_attention.flash_fwd`` and
``flash_attention.flash_bwd`` (dq and dk + dv), ``rms_norm.rms_norm_fwd``,
``rms_norm.rms_norm_bwd``, ``rope.rope_fwd`` (forward and backward),
``gemm_epilogue.gemm_epilogue``, ``quant_matmul.quantized_matmul``,
the optimizer's fused step ``multi_tensor_adam.multi_tensor_adam``,
the serving tick's seeded draw ``sample_rows.sample_rows`` (R1) and
``jax.random``'s keep masks, Gumbel noise and dropout
``threefry_fill.fill`` / ``threefry_fill.dropout`` (R2).
Flash attention, RMSNorm, rope and the GEMM epilogue sit behind autograd
Functions."""

"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built at first
use by ``_build``), each with its plain PyTorch version and a launch
counter on its wrapper: ``paged_attention.paged_attention``,
``ragged_prefill.ragged_prefill_attention``,
``fused_tick.fused_tick_attention``, ``flash_attention.flash_fwd`` and
``flash_attention.flash_bwd`` (dq and dk + dv), ``rms_norm.rms_norm_fwd``
and ``rms_norm.rms_norm_bwd``; the last two kernels sit behind autograd
Functions."""

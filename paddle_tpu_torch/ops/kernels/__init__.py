"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built at first
use by ``_build``), each with its plain PyTorch version and a launch
counter on its wrapper: ``paged_attention.paged_attention``,
``ragged_prefill.ragged_prefill_attention`` and
``fused_tick.fused_tick_attention``."""

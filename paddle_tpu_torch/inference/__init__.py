"""Serving: the continuous-batching server over the paged KV pool, its
host-side page allocator, its radix prefix cache, and ``serve_metrics``,
the HTTP exposition of its telemetry."""
from .continuous_batching import (ContinuousBatchingServer, PoolBalance,
                                  PreemptionPolicy)
from .kv_cache import NULL_PAGE, OutOfPages, PagedKVCache
from .prefix_cache import PrefixCache, PrefixMatch
from .serving import serve_metrics

__all__ = ["ContinuousBatchingServer", "PreemptionPolicy", "PoolBalance",
           "PagedKVCache",
           "OutOfPages", "NULL_PAGE", "PrefixCache", "PrefixMatch",
           "serve_metrics"]

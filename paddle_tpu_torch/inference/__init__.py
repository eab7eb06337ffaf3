"""Serving: the continuous-batching server over the paged KV pool, its
host-side page allocator and its radix prefix cache."""
from .continuous_batching import (ContinuousBatchingServer, PoolBalance,
                                  PreemptionPolicy)
from .kv_cache import NULL_PAGE, OutOfPages, PagedKVCache
from .prefix_cache import PrefixCache, PrefixMatch

__all__ = ["ContinuousBatchingServer", "PreemptionPolicy", "PoolBalance",
           "PagedKVCache",
           "OutOfPages", "NULL_PAGE", "PrefixCache", "PrefixMatch"]

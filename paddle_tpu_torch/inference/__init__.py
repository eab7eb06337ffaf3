"""Serving: the continuous-batching server over the paged KV pool, its
host-side page allocator, its radix prefix cache and host KV tier, the
in-process fleet (``ReplicaRouter`` over server replicas, disaggregated
placement), and ``serve_metrics``, the HTTP exposition of their
telemetry."""
from .continuous_batching import (ContinuousBatchingServer, PoolBalance,
                                  PreemptionPolicy)
from .kv_cache import NULL_PAGE, OutOfPages, PagedKVCache
from .kv_tier import HostTier
from .prefix_cache import PrefixCache, PrefixMatch, prefix_fingerprints
from .router import ReplicaRouter, RouterSupervisor
from .serving import serve_metrics

__all__ = ["ContinuousBatchingServer", "PreemptionPolicy", "PoolBalance",
           "PagedKVCache", "OutOfPages", "NULL_PAGE", "PrefixCache",
           "PrefixMatch", "prefix_fingerprints", "HostTier",
           "ReplicaRouter", "RouterSupervisor", "serve_metrics"]

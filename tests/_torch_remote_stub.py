"""Module-level replica factories for SPAWNED port hosts, and the torch
stub model they serve.

``remote.spawn_replica_host(factory)`` pickles the factory by
reference, so it must live in an importable module (not a test body).
A spawned child re-imports this module from scratch, so it imports only
torch, numpy and ``paddle_tpu_torch``: a port host's process holds no
JAX. The counterpart of ``tests/_remote_stub.py``.

``TorchStub`` follows the decode-bundle contract the port's server
consumes with the closed-form recurrence of ``tests/_serving_stub.py``;
``stub_tokens`` here is that module's oracle, copied so that nothing of
the JAX package is imported.
"""
import time

import numpy as np
import torch

from paddle_tpu_torch.inference import ContinuousBatchingServer

V = 16


def stub_tokens(prompt, n):
    """The n new tokens a stub-backed server must emit."""
    prompt = np.asarray(prompt).reshape(-1)
    T = len(prompt)
    toks = [(7 * int(prompt[-1]) + T) % V]
    t = T
    while len(toks) < n:
        toks.append((7 * toks[-1] + t + 1) % V)
        t += 1
    return np.asarray(toks[:n], np.int32)


def _onehot(nxt):
    return torch.nn.functional.one_hot(nxt.long() % V, V).float() * 10.0


class TorchStub:
    """The decode-bundle contract the port's server consumes, dense and
    paged (ragged-prefill and fused-tick entries included), with the
    closed-form recurrence of ``tests/_serving_stub.py``:

        first  = (7 * prompt[-1] + len(prompt)) % V          (prefill)
        tok_k+1 = (7 * tok_k + t_k + 1) % V,  t_k = T, T+1, ...

    Prefill writes token values into the cache rows (or pool pages) it
    covers, so page fills move real data; decode passes the caches
    through (logits depend only on the token and its position)."""

    L, H, HD = 1, 1, 2
    device = torch.device("cpu")

    def _decode_bundle(self, max_cache_len, weight_dtype=None, mesh=None,
                       cache_dtype=None, cache_backend="dense",
                       page_size=None, num_pages=None):
        L, h, hd = self.L, self.H, self.HD
        C = int(max_cache_len)

        def embed_fn(tok, t):
            return torch.stack([tok.float(), t.float()], -1)[:, None]

        def step_fn(x, caches, t):
            return x, caches

        def head_fn(out):
            tok, t = out[..., 0].long(), out[..., 1].long()
            return _onehot(7 * tok + t + 1)

        if cache_backend != "paged":
            def init_caches(batch):
                shape = (L, batch, C, h, hd)
                return {"k": torch.zeros(shape), "v": torch.zeros(shape)}
            return init_caches, embed_fn, step_fn, head_fn, None

        pg = int(page_size)
        maxp = C // pg

        def init_caches(batch):
            shape = (L, int(num_pages), pg, h, hd)
            return {"pool": {"k": torch.zeros(shape),
                             "v": torch.zeros(shape)},
                    "bt": torch.zeros((batch, maxp), dtype=torch.int32)}

        def write(pool, bt, pos, tokens, oob):
            W = bt.shape[1]
            page = torch.where(oob, 0, torch.gather(
                bt.long(), 1, torch.clamp(pos // pg, max=W - 1)))
            vals = torch.where(oob, 0, tokens).float().reshape(-1)
            for name in ("k", "v"):
                pool[name][:, page.reshape(-1), (pos % pg).reshape(-1)] = \
                    vals[None, :, None, None].expand(L, -1, h, hd)

        def logits_at(tokens, t0, out_idx):
            last = torch.gather(tokens.long(), 1,
                                out_idx.long()[:, None])[:, 0]
            return _onehot(7 * last + t0.long() + out_idx.long() + 1)

        def ragged(tokens, t0, caches, out_idx):
            pos = t0.long()[:, None] + torch.arange(tokens.shape[1])[None]
            write(caches["pool"], caches["bt"], pos, tokens,
                  pos // pg >= maxp)
            return logits_at(tokens, t0, out_idx), caches

        def fused(tokens, t0, last, dec, caches, out_idx, bt_live, ss, sp,
                  has_decode=None):
            pos = t0.long()[:, None] + torch.arange(tokens.shape[1])[None]
            oob = (pos // pg >= bt_live.shape[1]) \
                | (pos > last.long()[:, None])
            write(caches["pool"], bt_live, pos, tokens, oob)
            return logits_at(tokens, t0, out_idx), caches

        return (init_caches, embed_fn, step_fn, head_fn, None, ragged,
                fused)

    def _run_prefill(self, bundle, ids_np, chunk=None, caches=None, t0=0):
        ids = torch.from_numpy(np.asarray(ids_np, np.int64))
        B, T = ids.shape
        if caches is None:
            caches = bundle[0](B)
        vals = ids.float()[None, :, :, None, None]
        for name in ("k", "v"):
            caches[name][:, :, t0:t0 + T] = vals
        return _onehot(7 * ids[:, -1] + t0 + T), caches


def make_stub_server(**kw):
    """A paged ``TorchStub`` server with the router-test defaults; any
    kwarg overrides pass straight through (``do_sample=True`` for the
    seeded-sampling parity drills)."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("cache_backend", "paged")
    kw.setdefault("page_size", 8)
    return ContinuousBatchingServer(TorchStub(), **kw)


def make_slow_stub_server(tick_sleep_s=0.01, **kw):
    """A stub server whose serve tick is paced by ``tick_sleep_s``:
    kill drills need the decode loop slow enough that a call arriving
    over the wire reliably catches requests MID-decode."""
    srv = make_stub_server(**kw)
    inner = srv._fire_callbacks

    def paced():
        time.sleep(tick_sleep_s)
        inner()

    srv._fire_callbacks = paced
    return srv


def jax_free_report(**kw):
    """A stub server built after recording whether this process holds
    any JAX module (``sys.modules``): the report rides the server's
    ``stats`` (``"jax_modules"``), which the wire carries back."""
    import sys
    srv = make_stub_server(**kw)
    srv.stats["jax_modules"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "jaxlib" or m.startswith("jaxlib.")
        or m == "paddle_tpu" or m.startswith("paddle_tpu."))
    return srv

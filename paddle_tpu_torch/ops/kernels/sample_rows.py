"""Seeded categorical sampling, one row a slot (R1): the CUDA kernel and
its plain version.

Counterpart of the draw the JAX server jits into its tick programs
(``paddle_tpu/inference/continuous_batching.py:2039-2048``,
``:2492-2503``, ``:2545-2571``; jnp over ``jax.random``, no
``pallas_call``). For each slot row s of f32 ``logits [S, V]`` (already
through ``process_logits``):

    key_in  = PRNGKey(seeds[s]) if fresh[s] else keys[s]
    next, sub = split(key_in)
    tokens[s] = argmax(logits[s] + gumbel(sub, (1, V)))   # first maximum
    keys_out[s] = next if emit[s] else key_in
    bad[s] = any logit of raw[s] is NaN or infinite

``raw`` (default: the logits) is the model's row before the filters:
top-k and top-p fill a row holding a NaN or an Inf with ``-1e30``, so
the server flags the raw row (f32, bf16 or f16) inside the same launch.

``sample_rows`` launches ``csrc/sample_rows.cu`` for CUDA tensors (one
launch of one kernel for all the rows) and runs ``_ref_sample_rows`` for
CPU tensors; a CUDA tensor the kernel cannot take raises.
``sample_rows.launches`` counts the kernel's launches. A row spreads over
many blocks by ``plan`` (static shapes and the SM count; ``plan_cover``
models its walk), whose last block to finish merges the row; ``route``
picks 16-byte loads (``vector``) or one element at a time (``scalar``)
before the launch. The kernel and the plain version are bit
for bit equal on the card (the Gumbel noise's logs are f64 logs in both,
``core.prng.log_rn``); the plain version is ``jax.random``'s draw with
the Gumbel noise within two ulps of ``max(|g|, 1)`` and the tokens equal
(tests/test_torch_sampling.py).
"""
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...core import prng
from . import _build

__all__ = ["sample_rows", "plan", "plan_cover", "route", "ROW_CHUNK",
           "ROUTES"]

ROW_CHUNK = 64      # rows the plain version draws at a time
STEP = 8            # elements a thread takes a step (csrc: kStep)
BLOCKS_PER_SM = 2   # blocks the plan aims for, per SM
MAX_THREADS = 512   # csrc: kMaxThreads
ROUTES = ("vector", "scalar")


class Plan(NamedTuple):
    blocks: int     # blocks a row
    chunk: int      # elements a block walks (a multiple of STEP)
    threads: int    # threads a block


def plan(S, V, sm_count):
    """The kernel's static plan for ``S`` rows of ``V`` on a card of
    ``sm_count`` SMs: enough blocks a row that the grid holds
    ``BLOCKS_PER_SM`` blocks an SM (one a row once the rows alone do),
    each walking a chunk of whole 8-element steps, and threads enough
    (32 to 512, a power of two) for one step each where the chunk allows.
    Nothing here depends on the data."""
    want = max(1, -(-BLOCKS_PER_SM * sm_count // max(S, 1)))
    blocks = max(1, min(want, -(-V // STEP)))
    chunk = -(-(-(-V // blocks)) // STEP) * STEP
    blocks = -(-V // chunk)
    steps = -(-chunk // STEP)
    threads = min(MAX_THREADS, max(32, 1 << (steps - 1).bit_length()))
    return Plan(blocks, chunk, threads)


def plan_cover(p, V):
    """Plain model of the kernel's walk over plan ``p``: how many times
    each element of a row is taken, int64 ``[V]`` (all 1 for a plan that
    is right)."""
    cover = np.zeros(V, dtype=np.int64)
    for part in range(p.blocks):
        end = min(V, (part + 1) * p.chunk)
        for t in range(p.threads):
            for v0 in range(part * p.chunk + t * STEP, end,
                            p.threads * STEP):
                cover[v0:min(v0 + STEP, end)] += 1
    return cover


def route(logits, raw):
    """``vector`` when the f32 logits and the raw rows start on 16 bytes,
    row after row; else ``scalar``."""
    def aligned(t):
        return t.data_ptr() % 16 == 0 and \
            (t.stride(0) * t.element_size()) % 16 == 0
    return "vector" if aligned(logits) and aligned(raw) else "scalar"


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS = {}       # (device index, stream) -> int32 zeros, one a row


def _tickets(device, stream, S):
    """The row tickets of launches on ``stream`` of ``device``, grown to
    ``S`` rows (``stream`` is the current one). Every launch finds them
    zero and leaves them zero, so the launches that share them must run
    one after another: one buffer a stream (a launch aborted by a device
    fault leaves them dirty, but also the CUDA context unusable)."""
    at = (device.index, stream.cuda_stream)
    t = _TICKETS.get(at)
    if t is None or t.numel() < S:
        t = torch.zeros((max(S, 64),), dtype=torch.int32, device=device)
        _TICKETS[at] = t
    return t


def _ref_sample_rows(logits, keys, seeds, fresh, emit, raw=None):
    """Plain version: ``core.prng``'s ``split`` and the first maximum of
    ``logits + gumbel``, ``ROW_CHUNK`` rows at a time."""
    S, V = logits.shape
    dev = logits.device
    raw = logits if raw is None else raw
    # in int64 words: torch's uint32 has no where on CUDA
    k0, k1 = prng.key_data(keys.to(dev))
    fresh = fresh.to(dev) != 0
    key_in = prng.make_key(
        torch.where(fresh, 0, k0),
        torch.where(fresh, seeds.to(dev).to(torch.int64) & prng.MASK, k1))
    nxt, sub = prng.split(key_in).unbind(-2)
    emit = (emit.to(dev) != 0)[:, None]
    keys_out = torch.where(emit, nxt.view(torch.int32),
                           key_in.view(torch.int32)).view(torch.uint32)
    tokens = [torch.argmax(prng.gumbel_from_bits(prng.random_bits(
        sub[r0:r0 + ROW_CHUNK], (V,))) + logits[r0:r0 + ROW_CHUNK], -1)
        for r0 in range(0, S, ROW_CHUNK)]
    tokens = torch.cat(tokens).to(torch.int32) if tokens else \
        torch.zeros((0,), dtype=torch.int32, device=dev)
    bad = (~torch.isfinite(raw).all(-1)).to(torch.int32)
    return tokens, keys_out, bad


_RAW_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(logits, keys, seeds, fresh, emit, raw):
    """The kernel's contract, checked before any pointer leaves Python."""
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError(f"sample_rows takes f32 logits [S, V], got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    S, V = logits.shape
    if V < 1 or V >= 2 ** 31 - MAX_THREADS * STEP:
        raise ValueError(f"sample_rows: V = {V} out of [1, 2**31 - "
                         f"{MAX_THREADS * STEP})")
    if S > 65535:
        raise ValueError(f"sample_rows: S = {S} rows, at most 65535")
    if logits.stride(1) != 1:
        raise ValueError("sample_rows: logits rows must be contiguous")
    if raw.dtype not in _RAW_DTYPES or raw.shape != logits.shape \
            or raw.stride(1) != 1:
        raise TypeError(f"sample_rows: raw must be f32, bf16 or f16 [{S}, "
                        f"{V}] with contiguous rows, got {raw.dtype} "
                        f"{tuple(raw.shape)}")
    if keys.dtype != torch.uint32 or keys.shape != (S, 2) \
            or not keys.is_contiguous():
        raise TypeError(f"sample_rows: keys must be contiguous uint32 "
                        f"[{S}, 2], got {keys.dtype} {tuple(keys.shape)}")
    for name, t in (("seeds", seeds), ("fresh", fresh), ("emit", emit)):
        if t.dtype != torch.int32 or t.shape != (S,) \
                or not t.is_contiguous():
            raise TypeError(f"sample_rows: {name} must be contiguous int32 "
                            f"[{S}], got {t.dtype} {tuple(t.shape)}")
    for t in (keys, seeds, fresh, emit, raw):
        if t.device != logits.device:
            raise ValueError(f"sample_rows: an input is on {t.device}, the "
                             f"logits on {logits.device}")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def sample_rows(logits, keys, seeds, fresh, emit, raw=None):
    """One seeded draw per row of f32 ``logits [S, V]``; ``keys`` uint32
    ``[S, 2]``, ``seeds``, ``fresh``, ``emit`` int32 ``[S]`` and ``raw``
    (the rows the flags read, default ``logits``) on the logits' device.
    Returns ``(tokens int32 [S], keys_out uint32 [S, 2], bad int32 [S])``
    there. CUDA tensors launch the kernel, CPU tensors run the plain
    version."""
    if not logits.is_cuda:
        return _ref_sample_rows(logits, keys, seeds, fresh, emit, raw)
    raw = logits if raw is None else raw
    _check(logits, keys, seeds, fresh, emit, raw)
    S, dev = logits.shape[0], logits.device
    out = (torch.empty((S,), dtype=torch.int32, device=dev),
           torch.empty((S, 2), dtype=torch.uint32, device=dev),
           torch.empty((S,), dtype=torch.int32, device=dev))
    _launch(logits, keys, seeds, fresh, emit, raw, *out)
    return out


def _launch(logits, keys, seeds, fresh, emit, raw, tokens, keys_out, bad):
    """One launch into the given outputs (contiguous int32 ``[S]``, uint32
    ``[S, 2]`` and int32 ``[S]`` on the card) of inputs ``_check`` passed;
    ``keys_out`` may be ``keys``."""
    S, V = logits.shape
    dev = logits.device
    p = plan(S, V, sm_count(dev.index))
    r = route(logits, raw)
    stream = torch.cuda.current_stream(dev)
    ws = torch.empty((S, p.blocks, 4), dtype=torch.int32, device=dev) \
        if p.blocks > 1 else None
    fn = _build.function("sample_rows", "sample_rows_launch",
                         [_P, _L, _I, _I, _P, _L, _I, _P, _P, _P, _P, _P,
                          _P, _P, _I, _I, _I, _I, _P, _P, _P])
    err = fn(logits.data_ptr(), logits.stride(0), S, V, raw.data_ptr(),
             raw.stride(0), _RAW_DTYPES[raw.dtype], keys.data_ptr(),
             seeds.data_ptr(), fresh.data_ptr(), emit.data_ptr(),
             tokens.data_ptr(), keys_out.data_ptr(), bad.data_ptr(),
             p.blocks, p.chunk, p.threads, int(r == "vector"),
             None if ws is None else ws.data_ptr(),
             _tickets(dev, stream, S).data_ptr() if p.blocks > 1 else None,
             stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"sample_rows kernel launch failed: CUDA error "
                           f"{err}")
    sample_rows.launches += 1
    sample_rows.route_launches[r] += 1


sample_rows.launches = 0
sample_rows.route_launches = dict.fromkeys(ROUTES, 0)

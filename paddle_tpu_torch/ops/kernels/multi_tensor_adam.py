"""The optimizer's fused step: Adam / AdamW over every live parameter in
one multi-tensor pass (the CUDA kernel), its plain version and the chunk
plan.

Port of ``paddle_tpu/optimizer/optimizer.py:62`` (``_get_fused_step``):
the JAX package jits one XLA program that clips the live gradients by
their global norm and applies ``Adam._update_leaf`` to each parameter.
``multi_tensor_adam`` does the same in place: for CUDA tensors it
launches ``csrc/multi_tensor_adam.cu`` (a sum of squares a chunk and one
scale block when the global-norm clip is on, then one update over the
chunk table), for CPU tensors it runs the plain version
``_ref_multi_tensor_adam``, the per-leaf update (``adam_leaf``) in the
order of the tensors. A CUDA tensor the kernel cannot take raises; it
never falls back. ``multi_tensor_adam.launches`` counts the steps that
launched the kernel, ``.kernel_launches`` the kernels they launched (a
fixed number a step: ``kernels_per_step``).

The kernel's arithmetic is the plain version's on the CPU bit for bit
(true f32 divisions, no fused multiply-adds); on the card the plain
version divides by a Python number as a multiply by its reciprocal, so
the two may differ in the last f32 bit there (ROADMAP, Queue 3). The
global norm is summed in another order than torch's and XLA's: its
scale agrees to a few f32 ulps, never bit for bit.

The launch plan (``plan``) depends on the tensors' sizes only: chunks of
``CHUNK`` elements, one block each, in launch groups of at most
``MAX_TENSORS`` tensors (the gradient pointers ride each launch as a
kernel argument). ``plan_cover`` models the kernels' walk on the CPU.
The metadata and chunk tables are built once per live set (parameter,
moment and master pointers, sizes, types and weight decays) and kept on
the card in the caller's ``cache`` dict, as the reference's optimizer
keeps its jitted step in ``_fused_cache``.
"""
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["multi_tensor_adam", "adam_leaf", "bias_correction", "sqrt_rn",
           "plan",
           "plan_cover", "kernels_per_step", "CHUNK", "MAX_TENSORS"]

CHUNK = 16384          # csrc/multi_tensor_adam.cu: kChunk
MAX_TENSORS = 256      # kMaxTensors
THREADS = 256          # kThreads
VEC = 8                # kVec: elements a thread an iteration, 16-byte path
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class Plan(NamedTuple):
    # (first tensor, tensors, first chunk, chunks) of each launch group
    groups: tuple
    # int32 [chunks, 2]: (tensor within its group, chunk within the tensor)
    chunks: np.ndarray


def plan(numels, chunk=CHUNK, max_tensors=MAX_TENSORS):
    """The launch plan for tensors of ``numels`` elements: every tensor
    cut into ``chunk``-element chunks (the last one ragged), one block a
    chunk, tensors in groups of ``max_tensors`` a launch. Depends on the
    sizes only."""
    groups, rows = [], []
    first = 0
    for t0 in range(0, len(numels), max_tensors):
        part = numels[t0:t0 + max_tensors]
        cnt = [-(-int(n) // chunk) for n in part]
        rows.append(np.stack([np.repeat(np.arange(len(part)), cnt),
                              np.concatenate([np.arange(c) for c in cnt])
                              if cnt else np.zeros(0, np.int64)], 1))
        groups.append((t0, len(part), first, sum(cnt)))
        first += sum(cnt)
    table = np.concatenate(rows) if rows else np.zeros((0, 2))
    return Plan(tuple(groups), table.astype(np.int32).reshape(-1, 2))


def plan_cover(p, numels, aligned, chunk=CHUNK):
    """Plain model of the kernels' walk over plan ``p``: how many times
    each element of each tensor is visited, thread by thread, through
    the 16-byte body (``aligned[i]``: every pointer of tensor i on 16
    bytes) and the scalar tail. A list of int arrays, one per tensor;
    every entry is 1 for a plan that is right."""
    cover = [np.zeros(int(n), np.int64) for n in numels]
    for t0, nt, c0, nc in p.groups:
        for local, ci in p.chunks[c0:c0 + nc]:
            t = t0 + int(local)
            off = int(ci) * chunk
            length = min(chunk, int(numels[t]) - off)
            start = 0
            if aligned[t]:
                nv = length // VEC
                for tid in range(min(THREADS, nv)):
                    for i in range(tid, nv, THREADS):
                        cover[t][off + i * VEC:off + (i + 1) * VEC] += 1
                start = nv * VEC
            for tid in range(THREADS):
                idx = np.arange(start + tid, length, THREADS)
                np.add.at(cover[t], off + idx, 1)
    return cover


def kernels_per_step(n_tensors, clip):
    """Kernels one step launches over ``n_tensors`` live tensors: an
    update a launch group, and with the clip a sum of squares a group
    and one scale block."""
    groups = -(-n_tensors // MAX_TENSORS)
    return groups * (2 if clip else 1) + (1 if clip else 0)


def bias_correction(beta, step):
    """``1 - beta ** step`` in f32, as the JAX update computes it with an
    int32 step inside its jitted program."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(step))


def sqrt_rn(t):
    """The correctly rounded square root, as the card's ``sqrt``, the
    kernel's ``__fsqrt_rn`` and XLA's compute it. torch's f32 ``sqrt`` on
    the CPU goes through a vector-math library that misses by an ulp at
    about 0.6% of inputs; widened to f64 and rounded back it is exact
    (double rounding cannot move a square root)."""
    if t.device.type == "cpu" and t.dtype == torch.float32:
        return t.double().sqrt().float()
    return t.sqrt()


def adam_leaf(g, p, m, v, master, lr, beta1, beta2, eps, bc1, bc2, wd,
              decoupled):
    """``Adam._update_leaf`` (``optimizer.py:298-316``) on one tensor,
    operation for operation: returns (new p in f32, new m, new v). ``p``
    is read from the f32 ``master`` where one is given with elements."""
    g32 = g.float()
    p32 = master if master is not None and master.numel() else p.float()
    if wd and not decoupled:
        g32 = g32 + wd * p32
    m = beta1 * m + (1 - beta1) * g32
    v = beta2 * v + (1 - beta2) * g32.square()
    mhat = m / bc1
    vhat = v / bc2
    upd = mhat / (sqrt_rn(vhat) + eps)
    if wd and decoupled:
        upd = upd + wd * p32
    return p32 - lr * upd, m, v


def _ref_multi_tensor_adam(grads, params, exp_avgs, exp_avg_sqs, masters,
                           weight_decays, lr, beta1, beta2, epsilon, step,
                           decoupled, clip_norm=None, clip_scale=None):
    """Plain version: the global-norm clip as ``nn.ClipGradByGlobalNorm``
    computes it (or the given ``clip_scale``, an f32 scalar tensor), then
    ``adam_leaf`` tensor by tensor, everything written in place. Returns
    the f32 tensor [scale, global norm] when clipping, else None."""
    from ...nn.clip import _global_scale, _sq_sum
    info = None
    if clip_scale is not None:
        scale = clip_scale
        info = torch.stack([scale, torch.full_like(scale, float("nan"))])
    elif clip_norm is not None:
        scale, gn = _global_scale(_sq_sum(grads), clip_norm)
        info = torch.stack([scale, gn])
    bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
    for g, p, m, v, mp, wd in zip(grads, params, exp_avgs, exp_avg_sqs,
                                  masters, weight_decays):
        if info is not None:
            g = (g.float() * info[0]).to(g.dtype)
        new_p, new_m, new_v = adam_leaf(g, p, m, v, mp, lr, beta1, beta2,
                                        epsilon, bc1, bc2, wd, decoupled)
        m.copy_(new_m)
        v.copy_(new_v)
        if mp is not None and mp.numel():
            mp.copy_(new_p)
        p.copy_(new_p)
    return info


def _check(grads, params, exp_avgs, exp_avg_sqs, masters, weight_decays):
    """The kernel's contract, checked before any pointer leaves Python."""
    n = len(params)
    if not (len(grads) == len(exp_avgs) == len(exp_avg_sqs) == len(masters)
            == len(weight_decays) == n) or n == 0:
        raise ValueError("grads, params, moments, masters and decays must "
                         "be non-empty lists of one length")
    dev = params[0].device
    for i, (g, p, m, v, mp) in enumerate(zip(grads, params, exp_avgs,
                                             exp_avg_sqs, masters)):
        if p.dtype not in _DTYPES or g.dtype != p.dtype:
            raise TypeError(f"tensor {i}: the fused step takes f32, bf16 or "
                            f"f16 parameters with gradients of their type, "
                            f"got {p.dtype} / {g.dtype}")
        for name, t in (("grad", g), ("m", m), ("v", v), ("master", mp)):
            if t is None:
                continue
            if t.device != dev:
                raise ValueError(f"tensor {i}: {name} is on {t.device}, the "
                                 f"parameters on {dev}")
            if name != "grad" and (t.dtype != torch.float32
                                   or not t.is_contiguous()):
                raise TypeError(f"tensor {i}: {name} must be a contiguous "
                                f"f32 tensor")
        if g.shape != p.shape or m.shape != p.shape or v.shape != p.shape \
                or (mp is not None and mp.numel()
                    and mp.shape != p.shape):
            raise ValueError(f"tensor {i}: shapes differ: grad "
                             f"{tuple(g.shape)}, param {tuple(p.shape)}, m "
                             f"{tuple(m.shape)}, v {tuple(v.shape)}")
        if not p.is_contiguous():
            raise ValueError(f"tensor {i}: the parameter must be contiguous")


@functools.lru_cache(maxsize=64)
def _wd_bits(wd):
    """(the f32 bits of ``wd`` as an int, whether it decays)."""
    return int(np.float32(wd).view(np.int32)), int(bool(wd))


def _tables(params, exp_avgs, exp_avg_sqs, masters, weight_decays, cache):
    """(metadata [tensors, 8] int64, chunk table [chunks, 2] int32, plan)
    on the parameters' card for this live set: from ``cache`` (a dict the
    caller keeps) when the live set is the one it holds, else built and
    put there in its place."""
    rows = []
    for p, m, v, mp, wd in zip(params, exp_avgs, exp_avg_sqs, masters,
                               weight_decays):
        mptr = mp.data_ptr() if mp is not None and mp.numel() else 0
        rows.append((p.data_ptr(), m.data_ptr(), v.data_ptr(), mptr,
                     p.numel(), _DTYPES[p.dtype], *_wd_bits(wd)))
    key = (params[0].device, tuple(rows))
    hit = cache.get(key)
    if hit is None:
        dev = params[0].device
        p_ = plan([r[4] for r in rows])
        hit = (torch.tensor(rows, dtype=torch.int64).to(dev),
               torch.from_numpy(np.ascontiguousarray(p_.chunks)).to(dev), p_)
        cache.clear()
        cache[key] = hit
    return hit


def _fn(name, argtypes):
    return _build.function("multi_tensor_adam", name, argtypes)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"multi_tensor_adam {what} kernel launch failed: "
                           f"CUDA error {err}")


def multi_tensor_adam(grads, params, exp_avgs, exp_avg_sqs, masters,
                      weight_decays, *, lr, beta1, beta2, epsilon, step,
                      decoupled, clip_norm=None, cache=None):
    """One Adam (``decoupled=False``: L2 decay ``g + wd * p``) or AdamW
    (``decoupled=True``: ``upd + wd * p``) step of every tensor, in
    place: parameters, f32 moments ``exp_avgs`` / ``exp_avg_sqs`` and the
    f32 ``masters`` (None, or a 0-size sentinel, where a parameter has
    none). ``weight_decays``: a Python float a tensor (0 exempts it).
    ``step`` is 1-based (the bias corrections ``bias_correction``);
    ``lr`` a Python float. With ``clip_norm`` the gradients are first
    clipped by their global norm, each rounded back to its own type.
    ``cache``: a dict the caller keeps across steps, where the kernel's
    tables for the live set stay on the card (None: built every call).

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Returns the f32 tensor [clip scale, global norm] on the parameters'
    device when clipping (read it without a sync of its own), else
    None."""
    if not params[0].is_cuda:
        return _ref_multi_tensor_adam(
            grads, params, exp_avgs, exp_avg_sqs, masters, weight_decays,
            lr, beta1, beta2, epsilon, step, decoupled, clip_norm)
    _check(grads, params, exp_avgs, exp_avg_sqs, masters, weight_decays)
    info, kernels = _launch(grads, params, exp_avgs, exp_avg_sqs, masters,
                            weight_decays, lr, beta1, beta2, epsilon, step,
                            decoupled, clip_norm,
                            {} if cache is None else cache)
    # the kernel writes through raw pointers: bump the parameters'
    # version counters as an in-place torch op does, so autograd and
    # the copies made from a parameter (an int8 serving bundle's) see
    # the step
    torch.autograd.graph.increment_version(params)
    multi_tensor_adam.launches += 1
    multi_tensor_adam.kernel_launches += kernels
    return info


def _launch(grads, params, exp_avgs, exp_avg_sqs, masters, weight_decays,
            lr, beta1, beta2, epsilon, step, decoupled, clip_norm, cache):
    """Launch the kernels of one step on checked tensors: (the [scale,
    norm] tensor or None, the number of kernels launched)."""
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    meta, chunks, p_ = _tables(params, exp_avgs, exp_avg_sqs, masters,
                               weight_decays, cache)
    dev = params[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    gptrs = [(ctypes.c_uint64 * nt)(*[g.data_ptr()
                                      for g in grads[t0:t0 + nt]])
             for t0, nt, _, _ in p_.groups]
    info = None
    kernels = 0
    if clip_norm is not None:
        partials = torch.empty(max(1, len(p_.chunks)), dtype=torch.float32,
                               device=dev)
        info = torch.empty(2, dtype=torch.float32, device=dev)
        sumsq = _fn("mta_sumsq_launch", [_P, _P, _P, _I, _I, _P, _P])
        for (t0, nt, c0, nc), ptrs in zip(p_.groups, gptrs):
            _raise_on(sumsq(meta[t0].data_ptr(), chunks[c0].data_ptr()
                            if nc else chunks.data_ptr(), ptrs, nt, nc,
                            partials[c0:].data_ptr(), stream),
                      "sum of squares")
            kernels += 1
        _raise_on(_fn("mta_scale_launch", [_P, _I, _F, _P, _P])(
            partials.data_ptr(), len(p_.chunks), float(clip_norm),
            info.data_ptr(), stream), "clip scale")
        kernels += 1
    update = _fn("mta_update_launch", [_P, _P, _P, _I, _I, _P] + [_F] * 8
                 + [_I, _P])
    consts = [float(np.float32(x)) for x in (
        lr, beta1, 1 - beta1, beta2, 1 - beta2, epsilon,
        bias_correction(beta1, step), bias_correction(beta2, step))]
    for (t0, nt, c0, nc), ptrs in zip(p_.groups, gptrs):
        _raise_on(update(meta[t0].data_ptr(), chunks[c0].data_ptr()
                         if nc else chunks.data_ptr(), ptrs, nt, nc,
                         None if info is None else info.data_ptr(), *consts,
                         int(bool(decoupled)), stream), "update")
        kernels += 1
    return info, kernels


multi_tensor_adam.launches = 0
multi_tensor_adam.kernel_launches = 0

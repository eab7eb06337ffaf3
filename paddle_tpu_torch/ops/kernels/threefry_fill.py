"""``jax.random``'s element-wise draws and dropout on one stream (R2): the
CUDA kernel and its plain versions.

Counterpart of the draws the JAX package's functional ops take from
``jax.random`` (jnp, no ``pallas_call``), each over ``shape`` under one
key: ``keep_mask`` (bernoulli's ``uniform < p``, alpha_dropout's mask),
``gumbel`` (``-log(-log(uniform(minval, 1)))``, gumbel_softmax's noise,
the logs in f64 as ``core.prng.log_rn``); and ``dropout``, the keep mask
over a mask shape that broadcasts against the value, applied in the
value's type (``paddle_tpu/nn/functional.py:208-228``). The forward can
hand back the keep flags packed 8 to a byte (``save_mask``), and
``dropout_vjp`` applies the gradient from them without hashing again, as
the reference's vjp keeps ``keep`` as its residual.

Keys are ``uint32 [2]`` tensors (``core.random.next_key``); the kernel
takes their two words as arguments. The draws that make a tensor take a
``device``: CUDA launches ``csrc/threefry_fill.cu``, the CPU runs the
plain version (built from ``core.prng``); ``dropout`` follows its
value's device. A CUDA request the kernel cannot take raises.
``fill.launches`` counts the draws' launches, ``dropout.launches``
dropout's (forward and ``dropout_vjp``), and
``dropout.route_launches`` the same by route. Kernel and plain version
agree bit for bit (masks, Gumbel noise, dropout's values, saved bits).

Dropout's launch follows a plan from shapes alone (``dropout_plan``): the
value's axes collapse into runs of kept and broadcast axes, an item of
the kernel hashes 8 mask elements and walks the values that share them,
and every division by a run's extent is a multiply by a magic number
(``magic``) on the 32-bit routes. ``route`` picks the 16-byte body
(``vector``), one element at a time (``scalar``: unaligned pointers,
runs that hold no whole 16-byte pieces) or 64-bit indices (``wide``: 2**32
elements or more). ``plan_walk`` models the kernel's walk on the CPU.
"""
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ...core import prng
from . import _build

__all__ = ["gumbel", "keep_mask", "dropout", "dropout_vjp", "fill",
           "keep_threshold", "magic", "dropout_plan", "plan_walk", "route",
           "MAX_RANK", "ROUTES"]

MAX_RANK = 8                # csrc/threefry_fill.cu: kMaxRuns runs of a kind
CHUNK = 8                   # mask elements an item hashes: one saved byte
ROUTES = ("vector", "scalar", "wide")
ITEMS_PER_SM = 1024         # items a broadcast plan aims for, per SM
DEPTH = 4                   # walk steps a thread has in flight (kDepth)
_KEEP, _GUMBEL = 0, 1
_SCALE, _MASK, _SCALE_GRAD = 0, 1, 2
_GRAD_MODE = {_SCALE: _SCALE_GRAD, _MASK: _MASK}     # the vjp's mode
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _L, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_uint32)


def _words(key):
    k0, k1 = (int(w) for w in torch.as_tensor(key).reshape(2).tolist())
    return k0 & prng.MASK, k1 & prng.MASK


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"threefry_fill {what} kernel launch failed: CUDA "
                           f"error {err}")


def keep_threshold(p):
    """The kernel's keep test ``(bits >> 9) < T`` for ``unit_f32(bits) <
    f32(p)``: ``unit_f32`` is ``m * 2**-23`` for ``m = bits >> 9``, so
    ``T = ceil(f32(p) * 2**23)``, exact in f64, clamped to [0, 2**23] (a
    NaN keeps nothing)."""
    t = float(np.float32(p)) * 2.0 ** 23
    return 0 if not t > 0 else min(1 << 23, math.ceil(t))


def magic(d):
    """(magic, shift) of the kernel's 32-bit division by ``d`` >= 1: ``n //
    d == ((n * magic >> 32) + n) >> shift`` for every ``n < 2**32``
    (Granlund-Montgomery's round-up multiplier)."""
    shift = max(0, (int(d) - 1).bit_length())
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _udiv(n, mg):
    """The kernel's ``divide`` on 32-bit values (ints or int64 arrays)."""
    m, s = mg
    return (((n * m) >> 32) + n) >> s


def _ref_fill(key, shape, what, lo, device):
    """Plain version of ``fill`` on ``device``."""
    k0, k1 = _words(key)
    bits = prng.random_bits(prng.make_key(k0, k1).to(device), shape)
    if what == _KEEP:
        return prng.uniform_from_bits(bits) < torch.tensor(
            lo, dtype=torch.float32, device=device)
    return prng.gumbel_from_bits(bits, lo)


def fill(key, shape, what, device, lo):
    """One draw of ``shape`` under ``key``: ``what`` ``_KEEP`` the keep
    flags ``uniform < lo`` (bool), ``_GUMBEL`` the f32 Gumbel noise
    ``-log(-log(uniform(lo, 1)))``. CUDA launches the kernel, the CPU
    runs the plain version."""
    shape = tuple(int(s) for s in shape)
    device = torch.device(device)
    if device.type != "cuda":
        return _ref_fill(key, shape, what, lo, device)
    k0, k1 = _words(key)
    dtype = torch.uint8 if what == _KEEP else torch.float32
    out = torch.empty(shape, dtype=dtype, device=device)
    fn = _build.function("threefry_fill", "tf_fill_launch",
                         [_U, _U, _I, _P, _L, _F, _U, _P])
    _raise_on(fn(k0, k1, what, out.data_ptr(), out.numel(), float(lo),
                 keep_threshold(lo) if what == _KEEP else 0,
                 torch.cuda.current_stream(device).cuda_stream), "fill")
    fill.launches += 1
    return out.view(torch.bool) if what == _KEEP else out


fill.launches = 0


def gumbel(key, shape, device, minval=prng.TINY_F32):
    """``-log(-log(uniform(key, shape, float32, minval, 1)))``: at the
    default ``jax.random.gumbel(key, shape)`` (mode "low"), the logs in
    f64 rounded to f32."""
    return fill(key, shape, _GUMBEL, device, minval)


def keep_mask(key, shape, p, device):
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform < f32(p)`` (bool)."""
    return fill(key, shape, _KEEP, device, p)


def _mask_strides(shape, mask_shape):
    """Per axis of ``shape``, the flat-index stride of ``mask_shape`` (0
    where the mask broadcasts)."""
    strides, acc = [], 1
    for s, m in zip(reversed(shape), reversed(mask_shape)):
        strides.append(0 if m == 1 and s != 1 else acc)
        acc *= m
    return strides[::-1]


def _check_mask(shape, mask_shape):
    if len(mask_shape) != len(shape) or any(
            m not in (1, s) for m, s in zip(mask_shape, shape)):
        raise ValueError(f"dropout: mask shape {tuple(mask_shape)} does not "
                         f"broadcast against {tuple(shape)}")


def _collapse(shape, mask_shape):
    """The value's axes as runs ``[extent, kept]``, innermost first:
    axes of extent 1 dropped, neighbours of one kind merged."""
    runs = []
    for s, m in zip(reversed(shape), reversed(mask_shape)):
        if s == 1:
            continue
        kept = m == s
        if runs and runs[-1][1] == kept:
            runs[-1][0] *= s
        else:
            runs.append([s, kept])
    return runs or [[1, True]]


def _walk(runs, vector):
    """(broadcast positions, a chunk's walk steps) of collapsed ``runs``
    on the vector route or not: on the vector route the innermost
    broadcast run counts 8-element pieces; a chunk walks the positions
    once when its 8 mask elements are 8 consecutive values (vector,
    innermost run kept), else once a mask element."""
    steps = math.prod(n // (CHUNK if vector and i == 0 else 1)
                      for i, (n, kept) in enumerate(runs) if not kept)
    return steps, steps if vector and runs[0][1] else CHUNK * steps


def route(shape, mask_shape, aligned):
    """``vector`` when every pointer of the launch starts on 16 bytes
    (``aligned``) and the innermost run holds whole 8-element pieces (any
    length for a full mask, whose last piece runs element by element);
    else ``scalar``; ``wide`` (64-bit indices) where a 32-bit walk would
    overflow: from ~2**32 elements on."""
    runs = _collapse(shape, mask_shape)
    whole = (len(runs) == 1 and runs[0][1]) or runs[0][0] % CHUNK == 0
    r = "vector" if aligned and whole else "scalar"
    walk = _walk(runs, r == "vector")[1]
    if math.prod(shape) > (1 << 32) - 16 or (DEPTH + 1) * walk >= 1 << 32:
        return "wide"
    return r


class DropoutPlan(NamedTuple):
    route: str
    kept: tuple        # (len, vstride) a kept run, innermost first
    bcast: tuple       # (len, vstride) a broadcast run (units), innermost
    m: int             # mask elements
    chunks: int        # ceil(m / CHUNK)
    groups: int        # walk groups a chunk's steps split into
    steps: int         # positions along the broadcast runs
    walk: int          # a chunk's walk steps (steps or 8 x steps)
    group_fast: bool   # item = chunk * groups + group
    inner_kept: bool   # the innermost run is kept
    words: tuple       # the plan as the C entry point reads it


def dropout_plan(shape, mask_shape, aligned, sms, force_route=None):
    """The kernel's static plan for a value of ``shape`` under a mask of
    ``mask_shape`` on a card of ``sms`` SMs, on ``route``'s route or on
    ``force_route`` (scalar or wide: any shape takes them). Kept runs
    decompose a mask index into the value offset of its element, broadcast
    runs a walk step into the offset of its values; the vector route walks
    the innermost broadcast run in 8-element pieces. A broadcast mask's
    steps split into groups while the items stay below ``ITEMS_PER_SM`` an
    SM, so the card fills and each chunk is hashed ``groups`` times, not
    once per value. Nothing here depends on the data."""
    shape, mask_shape = tuple(shape), tuple(mask_shape)
    _check_mask(shape, mask_shape)
    r = route(shape, mask_shape, aligned)
    if force_route is not None and force_route != r:
        if force_route not in ("scalar", "wide"):
            raise ValueError(f"dropout: the {force_route} route needs what "
                             f"route() checks")
        r = force_route
    runs = _collapse(shape, mask_shape)
    kept, bcast, acc = [], [], 1
    for i, (n, k) in enumerate(runs):
        unit = CHUNK if (r == "vector" and i == 0 and not k) else 1
        (kept if k else bcast).append((n // unit, acc * unit))
        acc *= n
    if not kept:                            # a mask of one element
        kept.append((1, 0))
    m = math.prod(n for n, _ in kept)
    chunks = -(-m // CHUNK)
    steps, walk = _walk(runs, r == "vector")
    groups = min(walk, max(1, sms * ITEMS_PER_SM // chunks))
    group_fast = not runs[0][1]
    narrow = r != "wide"
    mg = magic(groups if group_fast else chunks) if narrow else (0, 0)
    words = [len(kept), len(bcast), int(group_fast), int(runs[0][1]), m,
             chunks, groups, steps, walk, *mg,
             *(magic(steps) if narrow else (0, 0))]
    for n, st in (*kept, *bcast):
        words += [n, st, *(magic(n) if narrow else (0, 0))]
    return DropoutPlan(r, tuple(kept), tuple(bcast), m, chunks, groups,
                       steps, walk, group_fast, bool(runs[0][1]),
                       tuple(words))


def _offsets(idx, runs, narrow):
    """The kernel's ``kept_offset`` / ``bcast_offset`` over int64 arrays."""
    off = np.zeros_like(idx)
    for r, (n, st) in enumerate(runs):
        here = idx
        if r + 1 < len(runs):
            q = _udiv(idx, magic(n)) if narrow else idx // n
            here, idx = idx - q * n, q
        off = off + here * st
    return off


def plan_walk(p, n):
    """Plain model of the kernel's walk over plan ``p`` for a value of
    ``n`` elements: (the mask index each value element takes, int64
    ``[n]``, -1 where none; how many times each is written). Every count
    is 1 for a plan that is right."""
    narrow = p.route != "wide"
    t = np.arange(p.chunks * p.groups, dtype=np.int64)
    if p.group_fast:
        ch = _udiv(t, magic(p.groups)) if narrow else t // p.groups
        g = t - ch * p.groups
    else:
        g = _udiv(t, magic(p.chunks)) if narrow else t // p.chunks
        ch = t - g * p.chunks
    width = CHUNK if p.route == "vector" else 1
    index = np.full(n, -1, dtype=np.int64)
    count = np.zeros(n, dtype=np.int64)
    for k in range(-(-p.walk // p.groups)):
        w = g + k * p.groups
        ok = w < p.walk
        if p.walk == p.steps:            # 8 mask elements, 8 values a step
            pairs = [(e, w) for e in range(CHUNK)]
        else:                            # mask element w / steps alone
            e = _udiv(w, magic(p.steps)) if narrow else w // p.steps
            pairs = [(e, w - e * p.steps)]
        for e, j in pairs:
            mi = ch * CHUNK + e
            live = ok & (mi < p.m)
            off = _offsets(np.where(live, mi, 0), p.kept, narrow) + \
                _offsets(np.where(live, j, 0), p.bcast, narrow)
            for lane in range(1 if p.walk == p.steps else width):
                at = off[live] + lane
                np.add.at(count, at, 1)
                index[at] = mi[live]
    return index, count


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_args(x, mask_shape, p, upscale):
    """(1 - p in f32, 1 - p rounded to x's type, the forward's mode)."""
    mask_shape = tuple(int(s) for s in mask_shape)
    _check_mask(tuple(x.shape), mask_shape)
    keep_p = 1.0 - p
    c = float(torch.tensor(keep_p, dtype=x.dtype)) if x.dtype in _DTYPES \
        else keep_p
    mode = _SCALE if upscale else _MASK
    return float(torch.tensor(keep_p, dtype=torch.float32)), c, mode


def _ref_pack(keep):
    """The saved mask: bit ``i % 8`` of byte ``i // 8`` is mask element
    ``i``'s keep flag (flat index), the last byte's spare bits 0."""
    flat = keep.reshape(-1).to(torch.uint8)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % CHUNK)])
    weights = torch.tensor([1 << e for e in range(CHUNK)], dtype=torch.uint8,
                           device=flat.device)
    return (flat.view(-1, CHUNK) * weights).sum(-1).to(torch.uint8)


def _ref_unpack(bits, mask_shape):
    """The keep flags of ``mask_shape`` from the saved mask."""
    shifts = torch.arange(CHUNK, dtype=torch.uint8, device=bits.device)
    flat = ((bits[:, None] >> shifts) & 1).reshape(-1)
    return flat[:math.prod(mask_shape)].bool().reshape(mask_shape)


def _ref_apply(x, keep, c, mode):
    """``where(keep, x / c, 0)``, ``where(keep, x, 0)`` or ``where(keep,
    x, 0) / c`` in x's type (a true division: the divisor lies on x's
    device)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == _MASK:
        return torch.where(keep, x, zero)
    c_t = torch.tensor(c, dtype=x.dtype, device=x.device)
    if mode == _SCALE:
        return torch.where(keep, x / c_t, zero)
    return torch.where(keep, x, zero) / c_t


def _ref_dropout(x, key, mask_shape, p, upscale, *, save_mask=False):
    """Plain version of ``dropout`` on x's device."""
    keep_p, c, mode = _plan_args(x, mask_shape, p, upscale)
    keep = _ref_fill(key, tuple(mask_shape), _KEEP, keep_p, x.device)
    out = _ref_apply(x, keep, c, mode)
    return (out, _ref_pack(keep)) if save_mask else out


def _ref_dropout_vjp(g, bits, mask_shape, p, upscale):
    """Plain version of ``dropout_vjp`` on g's device."""
    _, c, mode = _plan_args(g, mask_shape, p, upscale)
    return _ref_apply(g, _ref_unpack(bits, tuple(mask_shape)), c,
                      _GRAD_MODE[mode])


def _check_card(x):
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout takes f32, bf16 or f16 values on the "
                        f"card, got {x.dtype}")
    if x.dim() > MAX_RANK:
        raise ValueError(f"dropout: at most {MAX_RANK} axes on the card, "
                         f"got {x.dim()}")


def _launch(x, key, mask_shape, keep_p, c, mode, bits_in=None,
            save_mask=False, force_route=None):
    """One launch of the dropout kernel on the card: x's values (or
    gradient) under the mask drawn from ``key`` at keep probability
    ``keep_p``, or read from ``bits_in``; returns (out, saved bits or
    None). ``force_route`` takes another route than ``route`` would
    (the wide route on a small value, in checks)."""
    mask_shape = tuple(int(s) for s in mask_shape)
    x = x.contiguous()
    out = torch.empty_like(x)
    m = math.prod(mask_shape)
    bits = torch.empty((-(-m // CHUNK),), dtype=torch.uint8,
                       device=x.device) if save_mask else None
    if x.numel() == 0:
        return out, bits
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    p = dropout_plan(tuple(x.shape), mask_shape, aligned,
                     sm_count(x.device.index), force_route)
    words = (ctypes.c_longlong * len(p.words))(*p.words)
    fn = _build.function("threefry_fill", "tf_dropout_launch",
                         [_U, _U, _I, _P, _P, _P, _P, _I, _P, _I, _F, _U,
                          _P])
    k0, k1 = _words(key) if key is not None else (0, 0)
    _raise_on(fn(k0, k1, _DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
                 None if bits_in is None else bits_in.data_ptr(),
                 None if bits is None else bits.data_ptr(),
                 ROUTES.index(p.route), words, mode, c,
                 keep_threshold(keep_p),
                 torch.cuda.current_stream(x.device).cuda_stream),
              "dropout")
    dropout.launches += 1
    dropout.route_launches[p.route] += 1
    return out, bits


def dropout(x, key, mask_shape, p, upscale, *, save_mask=False):
    """Dropout of ``x`` under ``key``: keep where ``uniform(mask_shape) <
    1 - p`` (``mask_shape`` is x's shape with 1 on the axes the mask
    broadcasts over); ``upscale``: ``where(keep, x / (1 - p), 0)`` with
    ``1 - p`` rounded to x's type, else ``where(keep, x, 0)``;
    ``save_mask``: return ``(out, bits)``, the keep flags packed 8 to a
    byte for ``dropout_vjp``. CUDA tensors launch the kernel, CPU tensors
    run the plain version."""
    if not x.is_cuda:
        return _ref_dropout(x, key, mask_shape, p, upscale,
                            save_mask=save_mask)
    keep_p, c, mode = _plan_args(x, mask_shape, p, upscale)
    _check_card(x)
    out, bits = _launch(x, key, mask_shape, keep_p, c, mode,
                        save_mask=save_mask)
    return (out, bits) if save_mask else out


def dropout_vjp(g, bits, mask_shape, p, upscale):
    """Dropout's gradient at ``g`` from the mask ``dropout(...,
    save_mask=True)`` saved: ``where(keep, g, 0) / (1 - p)`` (``upscale``)
    or ``where(keep, g, 0)``, in g's type, no hash. CUDA tensors launch
    the kernel (counted on ``dropout.launches``), CPU tensors run the
    plain version."""
    if not g.is_cuda:
        return _ref_dropout_vjp(g, bits, mask_shape, p, upscale)
    keep_p, c, mode = _plan_args(g, mask_shape, p, upscale)
    _check_card(g)
    if bits.dtype != torch.uint8 or bits.device != g.device or \
            bits.numel() != -(-math.prod(mask_shape) // CHUNK):
        raise ValueError("dropout_vjp: the saved mask does not fit the "
                         "mask shape")
    return _launch(g, None, mask_shape, keep_p, c, _GRAD_MODE[mode],
                   bits_in=bits.contiguous())[0]


dropout.launches = 0
dropout.route_launches = dict.fromkeys(ROUTES, 0)

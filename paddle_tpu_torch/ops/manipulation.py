"""Shape and layout manipulation, indexing, gather / scatter and search.

Port of ``paddle_tpu/ops/manipulation.py``. Index tensors are cast to
int64 inside an op where torch needs it; what comes out is the
reference's int32. Indexing follows the reference: ``x[i]`` clamps an
out-of-range integer index (``x[7]`` on five elements is ``x[4]``), as
XLA's gather does, and negative slice steps work; ``__setitem__``
rebinds the tensor to the updated value and keeps its producer, as the
reference keeps its tape node (``manipulation.py:226-232``); an update
at an integer index out of range is dropped, as XLA's scatter drops
it. The
dynamic-shape ops (``unique``, ``unique_consecutive``) run on the host in
numpy, as the reference's do.
"""
import builtins

import numpy as np
import torch

from ..core.dtype import canonical, convert_dtype
from ..core.tensor import Tensor, _Rebind, as_value, dispatch, unwrap, wrap
from .math import pair, scalar_like
from .registry import register, register_direct

_slice = builtins.slice


def _long(i):
    return i.long() if isinstance(i, torch.Tensor) else \
        torch.as_tensor(np.asarray(i), dtype=torch.long)


def _wrap_neg(i, n):
    """Negative indices counted from the end, as jnp does."""
    i = _long(i)
    return torch.where(i < 0, i + n, i)

# ----------------------------------------------------------------- reshaping


@register("reshape", method=True)
def reshape(x, shape):
    return torch.reshape(x, tuple(int(unwrap(s)) for s in shape)
                         if isinstance(shape, (list, tuple)) else shape)


@register("flatten", method=True)
def flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


@register("squeeze", method=True)
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a for a in axis if x.shape[a] == 1)
    return torch.squeeze(x, axis) if axis else x


@register("unsqueeze", method=True)
def unsqueeze(x, axis):
    if isinstance(axis, int):
        return torch.unsqueeze(x, axis)
    nd = x.dim() + len(axis)
    for a in sorted(a % nd for a in axis):
        x = torch.unsqueeze(x, a)
    return x


@register("transpose", method=True)
def transpose(x, perm=None):
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return torch.permute(x, tuple(perm))


@register("moveaxis", method=True)
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@register("swapaxes", method=True)
def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, axis1, axis2)


@register("broadcast_to", method=True)
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape))


@register("expand", method=True)
def expand(x, shape):
    shape = [s if s != -1 else x.shape[i - (len(shape) - x.dim())]
             for i, s in enumerate(shape)]
    return torch.broadcast_to(x, tuple(shape))


@register("expand_as")
def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@register("tile", method=True)
def tile(x, repeat_times):
    return torch.tile(x, tuple(repeat_times) if isinstance(
        repeat_times, (list, tuple)) else (repeat_times,))


@register("repeat_interleave", method=True)
def repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.long()
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("flip", method=True)
def flip(x, axis):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


@register("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@register("roll", method=True)
def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, axis)


@register("as_complex")
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@register("as_real")
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


# ------------------------------------------------------------- join / split


def _stack_list(name, fn):
    def op(x, *args, **kwargs):
        return dispatch(lambda *vs: fn(vs, *args, **kwargs), *list(x),
                        name=name)
    op.__name__ = name
    return register_direct(name, op)


def concat(x, axis=0):
    """paddle.concat(list_of_tensors, axis)."""
    return dispatch(lambda *vs: torch.cat(vs, dim=axis), *x, name="concat")


register_direct("concat", concat)


def stack(x, axis=0):
    return dispatch(lambda *vs: torch.stack(vs, dim=axis), *x, name="stack")


register_direct("stack", stack)
_stack_list("vstack", torch.vstack)
_stack_list("hstack", torch.hstack)
_stack_list("dstack", torch.dstack)
_stack_list("row_stack", torch.vstack)
_stack_list("column_stack", torch.column_stack)


def _equal_parts(x, n, axis):
    dim = x.shape[axis]
    if dim % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {dim} into {n}")
    return tuple(torch.split(x, dim // n, dim=axis))


@register("split", method=True)
def split(x, num_or_sections, axis=0):
    if isinstance(num_or_sections, int):
        return _equal_parts(x, num_or_sections, axis)
    sizes = list(num_or_sections)
    dim = x.shape[axis]
    if builtins.any(s == -1 for s in sizes):
        known = builtins.sum(s for s in sizes if s != -1)
        sizes = [dim - known if s == -1 else s for s in sizes]
    return tuple(torch.split(x, sizes, dim=axis))


@register("chunk", method=True)
def chunk(x, chunks, axis=0):
    return _equal_parts(x, chunks, axis)


@register("unbind", method=True)
def unbind(x, axis=0):
    return tuple(torch.unbind(x, axis))


@register("unstack")
def unstack(x, axis=0, num=None):
    return tuple(torch.unbind(x, axis))


# --------------------------------------------------------------- slicing


def _range_index(s, n):
    """A slice as an index tensor (for negative steps, which torch's
    basic slicing refuses)."""
    return torch.arange(*s.indices(n))


def _basic(x, idx):
    """``x[idx]`` for a tuple of slices; negative steps via an index."""
    if builtins.all(not isinstance(s, _slice) or s.step is None
                    or s.step > 0 for s in idx):
        return x[idx]
    out = x
    for d, s in enumerate(idx):
        if isinstance(s, _slice) and s.step is not None and s.step < 0:
            out = torch.index_select(
                out, d, _range_index(s, x.shape[d]).to(x.device))
        elif isinstance(s, _slice):
            out = out[(_slice(None),) * d + (s,)]
    return out


@register("slice")
def slice(x, axes, starts, ends):  # noqa: A001
    idx = [_slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = _slice(st, en)
    return x[tuple(idx)]


@register("strided_slice")
def strided_slice(x, axes, starts, ends, strides):
    idx = [_slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = _slice(st, en, sd)
    return _basic(x, tuple(idx))


@register("crop")
def crop(x, shape, offsets=None):
    offsets = offsets or [0] * x.dim()
    return x[tuple(_slice(o, o + s) for o, s in zip(offsets, shape))]


def _norm_index(x, index, clamp):
    """``index`` (as for ``x[index]``) with Tensors unwrapped, numpy
    arrays and lists as tensors on x's device, negative slice steps as
    index tensors, and, with ``clamp``, each integer index wrapped from
    the end and clamped into its axis (XLA's gather)."""
    if not isinstance(index, tuple):
        index = (index,)
    index = tuple(unwrap(i) for i in index)
    n_ell = builtins.sum(1 for i in index if i is Ellipsis)
    used = builtins.sum(
        i.dim() if isinstance(i, torch.Tensor) and i.dtype == torch.bool
        else 0 if (i is None or i is Ellipsis) else 1 for i in index)
    out = []
    d = 0
    for i in index:
        if i is Ellipsis:
            out.append(i)
            d += x.dim() - used
            continue
        if i is None:
            out.append(i)
            continue
        if isinstance(i, (list, np.ndarray)):
            i = torch.as_tensor(np.asarray(i), device=x.device)
        if isinstance(i, torch.Tensor):
            if i.dtype == torch.bool:
                out.append(i)
                d += i.dim()
                continue
            n = x.shape[d]
            i = i.long()
            if clamp:
                i = torch.where(i < 0, i + n, i).clamp(0, builtins.max(n - 1,
                                                                       0))
            out.append(i)
        elif isinstance(i, _slice):
            if i.step is not None and i.step < 0:
                i = _range_index(i, x.shape[d]).to(x.device)
            out.append(i)
        else:
            i = int(i)
            n = x.shape[d]
            if clamp:
                i = builtins.min(builtins.max(i + n if i < 0 else i, 0),
                                 n - 1)
            out.append(i)
        d += 1
    if n_ell == 0 and len(out) == 1:
        return out[0]
    return tuple(out)


def _getitem(x, index):
    idx = _norm_index(unwrap(x), index, clamp=True)
    return dispatch(lambda v: v[idx], x, name="getitem")


def _int_out_of_range(x, index):
    """Whether a Python integer in ``index`` lies outside its axis (the
    reference's scatter drops such an update)."""
    if not isinstance(index, tuple):
        index = (index,)
    if builtins.any(i is Ellipsis or i is None or (
            isinstance(unwrap(i), torch.Tensor)
            and unwrap(i).dtype == torch.bool) for i in index):
        return False
    for d, i in enumerate(index):
        if isinstance(i, (int, np.integer)) and not isinstance(i, bool):
            n = x.shape[d]
            if not -n <= i < n:
                return True
    return False


def _setitem(self, index, value):
    old = self._value
    if _int_out_of_range(old, index):
        return
    idx = _norm_index(old, index, clamp=False)
    val = unwrap(value)
    if isinstance(val, np.ndarray):
        val = as_value(val, device=old.device)
    with torch.no_grad():
        new = old.detach().clone()
        new[idx] = val.to(old.dtype) if isinstance(val, torch.Tensor) \
            else val
    if old.grad_fn is None:
        if old.requires_grad:
            new.requires_grad_(True)
            new.grad = old.grad
        self._rebind(new)
    else:
        self._rebind(_Rebind.apply(old, new))


Tensor.__getitem__ = _getitem
Tensor.__setitem__ = _setitem


# --------------------------------------------------------------- gather etc


def _take(x, index, axis):
    """``jnp.take(x, index, axis)`` for in-range indices: any index
    shape, negative indices from the end."""
    axis = axis % x.dim()
    i = _wrap_neg(index, x.shape[axis])
    out = torch.index_select(x, axis, i.reshape(-1))
    return out.reshape(x.shape[:axis] + i.shape + x.shape[axis + 1:])


@register("gather", method=True, nondiff_args=(1,))
def gather(x, index, axis=0):
    return _take(x, index, axis)


@register("gather_nd", method=True, nondiff_args=(1,))
def gather_nd(x, index):
    return x[tuple(_long(index).movedim(-1, 0))]


@register("take_along_axis", nondiff_args=(1,))
def take_along_axis(arr, indices, axis, broadcast=True):
    return torch.take_along_dim(arr, _wrap_neg(indices, arr.shape[axis]),
                                dim=axis)


def _along_index(arr, indices, axis):
    i = _wrap_neg(indices, arr.shape[axis])
    shape = list(torch.broadcast_shapes(
        tuple(i.shape), tuple(s if d != axis else i.shape[axis]
                              for d, s in enumerate(arr.shape))))
    return i.expand(shape)


@register("put_along_axis", nondiff_args=(1,))
def put_along_axis(arr, indices, values, axis, reduce="assign"):
    i = _along_index(arr, indices, axis)
    v = values if isinstance(values, torch.Tensor) else \
        scalar_like(values, arr)
    v = v.to(arr.dtype).expand(i.shape)
    if reduce == "assign":
        return torch.scatter(arr, axis, i, v)
    if reduce == "add":
        return torch.scatter_add(arr, axis, i, v)
    raise NotImplementedError(reduce)


def _update(x, idx, updates, accumulate):
    u = updates if isinstance(updates, torch.Tensor) else \
        scalar_like(updates, x)
    return torch.index_put(x, idx, u.to(x.dtype), accumulate=accumulate)


@register("scatter", nondiff_args=(1,))
def scatter(x, index, updates, overwrite=True):
    return _update(x, (_wrap_neg(index, x.shape[0]),), updates,
                   not overwrite)


@register("scatter_nd_add", nondiff_args=(1,))
def scatter_nd_add(x, index, updates):
    return _update(x, tuple(_long(index).movedim(-1, 0)), updates, True)


@register("index_select", method=True, nondiff_args=(1,))
def index_select(x, index, axis=0):
    return _take(x, index, axis)


@register("index_add", nondiff_args=(1,))
def index_add(x, index, axis, value):
    return torch.index_add(x, axis, _wrap_neg(index, x.shape[axis]),
                           value.to(x.dtype))


@register("index_put", nondiff_args=(1,))
def index_put(x, indices, value, accumulate=False):
    return _update(x, tuple(_long(i) for i in indices), value, accumulate)


@register("where")
def where(condition, x=None, y=None):
    if x is None and y is None:
        return tuple(i.to(torch.int32) for i in torch.where(condition))
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x, y = pair(x, y)
    elif not isinstance(x, torch.Tensor):
        x = scalar_like(x, y)
    elif not isinstance(y, torch.Tensor):
        y = scalar_like(y, x)
    return torch.where(condition.bool(), x, y)


@register("select_scatter")
def select_scatter(x, values, axis, index):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


@register("masked_fill", method=True)
def masked_fill(x, mask, value):
    v = value if isinstance(value, torch.Tensor) else scalar_like(value, x)
    return torch.where(mask.bool(), v, x)


@register("diagonal", method=True)
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@register("diag")
def diag(x, offset=0, padding_value=0):
    if x.dim() == 1 and padding_value != 0:
        n = x.shape[0] + builtins.abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        keep = torch.ones((n, n), dtype=torch.bool,
                          device=x.device).diagonal(offset)
        mask = torch.zeros((n, n), dtype=torch.bool, device=x.device)
        mask.diagonal(offset).copy_(keep)
        return torch.where(mask, torch.diag(x, offset), base)
    return torch.diag(x, offset)


@register("diag_embed")
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    # as the reference: offset and dims apply to a 1-D input only
    if x.dim() > 1:
        return torch.diag_embed(x)
    return torch.diag(x, offset)


@register("diagflat")
def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


@register("tril", method=True)
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@register("triu", method=True)
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    period = 2 * (n - 1)                 # reflect, the edge not repeated
    i = i.abs().remainder(period)
    return torch.where(i >= n, period - i, i)


@register("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):  # noqa: A002
    if len(pad) == 2 * x.dim():
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        # the last len(pad)//2 dims, in order
        n = len(pad) // 2
        width = [(0, 0)] * (x.dim() - n) + [
            (pad[2 * i], pad[2 * i + 1]) for i in range(n)]
    if mode == "constant":
        flat = []
        for b, a in reversed(width):
            flat += [b, a]
        return torch.nn.functional.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise KeyError(mode)
    for d, (b, a) in enumerate(width):
        if b or a:
            x = torch.index_select(x, d, _pad_index(x.shape[d], b, a, mode,
                                                    x.device))
    return x


# --------------------------------------------------------------- search/sort


def _arg(fn, x, axis, keepdim):
    if axis is None:
        out = fn(x.reshape(-1), 0)
        return out.reshape([1] * x.dim()) if keepdim else out
    return fn(x, axis, keepdim=keepdim)


@register("argmax", method=True)
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    out = _arg(torch.argmax, x, axis, keepdim)
    return out.to(canonical(convert_dtype(dtype))) if dtype else out


@register("argmin", method=True)
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    out = _arg(torch.argmin, x, axis, keepdim)
    return out.to(canonical(convert_dtype(dtype))) if dtype else out


@register("argsort", method=True)
def argsort(x, axis=-1, descending=False, stable=True):
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


@register("sort", method=True)
def sort(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


@register("topk", method=True)
def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    v, i = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return v, i


@register("kthvalue", method=True)
def kthvalue(x, k, axis=-1, keepdim=False):
    v, i = torch.sort(x, dim=axis, stable=True)
    vk, ik = v.select(axis, k - 1), i.select(axis, k - 1)
    if keepdim:
        vk, ik = vk.unsqueeze(axis), ik.unsqueeze(axis)
    return vk, ik


@register("mode", method=True)
def mode(x, axis=-1, keepdim=False):
    """The most frequent value (the smallest of equally frequent ones)
    and the index of its first occurrence, as the reference computes
    them (a sort and run counts)."""
    xm = torch.movedim(x, axis, -1)
    srt = torch.sort(xm, dim=-1, stable=True).values
    counts = (srt.unsqueeze(-1) == srt.unsqueeze(-2)).sum(-1)
    best = torch.argmax(counts, dim=-1, keepdim=True)
    vals = torch.gather(srt, -1, best)
    idx = torch.argmax((xm == vals).to(torch.int8), dim=-1, keepdim=True)
    vals, idx = vals.squeeze(-1), idx.squeeze(-1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


@register("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    if sorted_sequence.dim() > 1:
        values = values.reshape(tuple(sorted_sequence.shape[:-1]) + (-1,))
    return torch.searchsorted(sorted_sequence.contiguous(),
                              values.contiguous(), right=right)


@register("bucketize")
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence.contiguous(), x.contiguous(),
                              right=right)


@register("bincount")
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x.long(), weights=weights, minlength=minlength)


@register("histogram")
def histogram(x, bins=100, min=0, max=0):  # noqa: A002
    lo, hi = (x.min().item(), x.max().item()) if (min == 0 and max == 0) \
        else (min, max)
    return torch.histc(x.to(torch.float32), bins=bins, min=lo, max=hi)


# ------------------------------------------------- dynamic-shape (eager only)


def nonzero(x, as_tuple=False):
    idx = torch.nonzero(unwrap(x)).to(torch.int32)
    if as_tuple:
        return tuple(wrap(i) for i in idx.unbind(-1))
    return wrap(idx)


register_direct("nonzero", nonzero, method=True)


def masked_select(x, mask):
    xv = unwrap(x)
    m = as_value(mask, device=xv.device).bool()
    return dispatch(lambda v: torch.masked_select(v, m), x,
                    name="masked_select")


register_direct("masked_select", masked_select, method=True)


def _host(x):
    v = unwrap(x).detach()
    return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy(), \
        v.device


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    xv, dev = _host(x)
    res = np.unique(xv, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(wrap(as_value(r, device=dev)) for r in res)
    return wrap(as_value(res, device=dev))


register_direct("unique", unique, method=True)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    xv, dev = _host(x)
    vals = []
    prev = object()
    for v in xv.reshape(-1) if axis is None else xv:
        if not np.array_equal(v, prev):
            vals.append(v)
        prev = v
    return wrap(as_value(np.array(vals), device=dev))


register_direct("unique_consecutive", unique_consecutive)


# --------------------------------------------------------------- dtype/cast


@register("cast", method=True)
def cast(x, dtype):
    return x.to(canonical(convert_dtype(dtype)))


def astype(x, dtype):
    return cast(x, dtype)


register_direct("astype", astype, method=True)


@register("numel", method=True)
def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


@register("one_hot")
def one_hot(x, num_classes):
    """float32 rows; an index outside [0, num_classes) gives a zero row,
    as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


@register("meshgrid")
def meshgrid(*args):
    return tuple(torch.meshgrid(*args, indexing="ij"))


@register("atleast_1d")
def atleast_1d(x):
    return torch.atleast_1d(x)


@register("atleast_2d")
def atleast_2d(x):
    return torch.atleast_2d(x)


@register("atleast_3d")
def atleast_3d(x):
    return torch.atleast_3d(x)


# ------------------------------------------ reshaping/stacking tail


@register("unflatten", method=True)
def unflatten(x, axis, shape):
    return torch.unflatten(x, axis, tuple(shape))


@register("view", method=True)
def view(x, shape_or_dtype):
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(list(shape_or_dtype))
    return x.view(convert_dtype(shape_or_dtype))


@register("as_strided", method=True)
def as_strided(x, shape, stride, offset=0):
    flat = x.reshape(-1)
    idx = offset + builtins.sum(
        torch.arange(s, device=x.device).reshape(
            [-1 if i == d else 1 for i in range(len(shape))]) * st
        for d, (s, st) in enumerate(zip(shape, stride)))
    return flat[idx.reshape(-1)].reshape(list(shape))


@register("tensor_split", nondiff_args=(1,))
def tensor_split(x, num_or_indices, axis=0):
    return tuple(torch.tensor_split(x, num_or_indices, dim=axis))


@register("hsplit", nondiff_args=(1,))
def hsplit(x, num_or_indices):
    return tuple(torch.hsplit(x, num_or_indices))


@register("vsplit", nondiff_args=(1,))
def vsplit(x, num_or_indices):
    return tuple(torch.vsplit(x, num_or_indices))


@register("dsplit", nondiff_args=(1,))
def dsplit(x, num_or_indices):
    return tuple(torch.dsplit(x, num_or_indices))


@register("fliplr", method=True)
def fliplr(x):
    return torch.fliplr(x)


@register("flipud", method=True)
def flipud(x):
    return torch.flipud(x)


@register("block_diag")
def block_diag(*inputs):
    return torch.block_diag(*inputs)


@register("take", method=True, nondiff_args=(1,))
def take(x, index, mode="raise"):
    """Flat-index gather; ``mode="raise"`` checks the bounds (a host
    read), then clamps as ``"clip"`` does; ``"wrap"`` wraps."""
    n = x.numel()
    i = _long(index).to(x.device)
    if mode == "raise" and bool(((i < -n) | (i >= n)).any()):
        raise IndexError(f"take index out of range for {n} elements")
    if mode == "wrap":
        i = i.remainder(n)
    else:
        i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return x.reshape(-1)[i]


@register("index_fill", method=True, nondiff_args=(1,))
def index_fill(x, index, axis, value):
    return torch.index_fill(x, axis, _wrap_neg(index, x.shape[axis]),
                            value)


@register("masked_scatter", method=True, nondiff_args=(1,))
def masked_scatter(x, mask, value):
    """Masked slots take value's leading elements in row-major order;
    too few elements is an error (a host read, as the reference's)."""
    flat_m = mask.reshape(-1).bool()
    needed = int(flat_m.sum())
    if value.numel() < needed:
        raise ValueError(
            f"masked_scatter: value has {value.numel()} elements, mask "
            f"needs {needed}")
    pos = torch.cumsum(flat_m.to(torch.int32), 0) - 1
    src = value.reshape(-1)[pos.clamp(0, value.numel() - 1).long()]
    return torch.where(flat_m, src, x.reshape(-1)).reshape(x.shape)


# ------------------------------------------------ top-level parity tail


def multiplex(inputs, index, name=None):
    """Row-wise select among candidate tensors: inputs list of [B, ...],
    index [B, 1] -> out[b] = inputs[index[b]][b]."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]

    def fn(idx, *cands):
        stacked = torch.stack(cands)
        i = idx.reshape(-1).long()
        return stacked[i, torch.arange(stacked.shape[1],
                                       device=stacked.device)]

    return dispatch(fn, index, *inputs, nondiff_args=(0,), name="multiplex")


register_direct("multiplex", multiplex)


@register("index_sample", nondiff_args=(1,))
def index_sample(x, index):
    """Per-row gather: x [B, N], index [B, M] -> x[b, index[b, m]]."""
    return torch.take_along_dim(x, index.long(), dim=-1)


@register("increment")
def increment(x, value=1.0):
    return x + scalar_like(value, x).to(x.dtype)


@register("shard_index")
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    """Global ids -> shard-local ids (``ignore_value`` off the shard)."""
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size
    inside = (input >= lo) & (input < lo + size)
    return torch.where(inside, input - lo, scalar_like(ignore_value, input))


@register("scatter_nd", nondiff_args=(0,))
def scatter_nd(index, updates, shape):
    out = torch.zeros(list(shape), dtype=updates.dtype,
                      device=updates.device)
    return torch.index_put(out, tuple(_long(index).movedim(-1, 0)),
                           updates, accumulate=True)


@register("reverse", method=True)
def reverse(x, axis):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


def add_n(inputs, name=None):
    """Elementwise sum of a tensor list."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    return dispatch(lambda *vs: builtins.sum(vs[1:], vs[0]), *inputs,
                    name="add_n")


register_direct("add_n", add_n)


@register("is_empty")
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


@register("shape", nondiff_args=(0,))
def shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@register("broadcast_shape", nondiff_args=(0, 1))
def _broadcast_shape_op(x_shape, y_shape):
    return tuple(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


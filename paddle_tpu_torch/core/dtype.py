"""Dtype names and conversion helpers of the tensor API.

Port of ``paddle_tpu/core/dtype.py``: the same names, as ``torch.dtype``
objects. The reference runs JAX with 64-bit types off, so an array it
makes is never int64, float64 or complex128: ``jnp.asarray`` gives
int32, float32 and complex64 instead. ``canonical`` is that rule, and
every tensor the API makes or returns goes through it
(``to_tensor(np.arange(3))`` is int32, ``sum`` of an int32 tensor is
int32, ``cast(x, "int64")`` is int32).
"""
import numpy as np
import torch

__all__ = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128",
           "convert_dtype", "canonical", "dtype_name", "is_floating",
           "from_numpy_dtype", "to_numpy_dtype"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "float16": float16, "fp16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}

# the reference's x64-off narrowing (jax_enable_x64 is off)
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def convert_dtype(dtype):
    """A dtype-like (a name, a numpy dtype or type, a ``torch.dtype``) as
    a ``torch.dtype``; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR2DTYPE:
            raise ValueError(f"unknown dtype string: {dtype!r}")
        return _STR2DTYPE[dtype]
    return from_numpy_dtype(np.dtype(dtype))


def canonical(dtype):
    """The type the reference's arrays take for ``dtype``: int64, float64
    and complex128 narrow to int32, float32 and complex64."""
    return _NARROW.get(dtype, dtype)


def from_numpy_dtype(nd):
    name = nd.name
    if name not in _STR2DTYPE:
        raise ValueError(f"no torch dtype for numpy dtype {name!r}")
    return _STR2DTYPE[name]


def to_numpy_dtype(dtype):
    """The numpy dtype of ``dtype``; bf16 has none on the card's host
    (no ``ml_dtypes``), so it maps to float32, the type ``numpy()``
    copies bf16 out as."""
    return np.dtype("float32") if dtype == torch.bfloat16 \
        else np.dtype(dtype_name(dtype))


def dtype_name(dtype):
    """``"float32"``, ``"bfloat16"``, ``"bool"``, ... of a dtype-like."""
    return str(convert_dtype(dtype)).replace("torch.", "")


def is_floating(dtype):
    return convert_dtype(dtype).is_floating_point

"""paddle.save / paddle.load in the JAX package's pickle format.

Port of ``paddle_tpu/io/save_load.py``: a nested structure (dicts, lists,
tuples) is pickled with every tensor as a numpy array, and a bf16 tensor
(numpy has no bfloat16) as ``{"__bf16__": True, "data": <f32 array>}``,
which is exact. No torch object is pickled, so a file written by either
package loads in the other. ``load`` returns torch CPU tensors: every
numpy array a torch dtype can hold becomes one (others stay arrays), and
a bf16 entry becomes a bf16 tensor.
"""
import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

_BF16_TAG = "__bf16__"


def _encode(obj):
    """``obj`` with every tensor as a host numpy array (bf16 tagged and
    widened to f32)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_BF16_TAG: True, "data": t.float().numpy()}
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    return obj


def _tensor(a):
    """A numpy array as a CPU tensor sharing its memory, or the array
    itself where torch has no such dtype (strings, objects)."""
    try:
        return torch.from_numpy(a)
    except TypeError:
        return a


def _decode(obj):
    if isinstance(obj, dict):
        if obj.get(_BF16_TAG):
            return torch.from_numpy(np.asarray(obj["data"],
                                               np.float32)).bfloat16()
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return _tensor(obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_encode(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        return _decode(pickle.load(f))

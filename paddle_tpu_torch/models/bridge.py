"""Copy a JAX-package model's parameters into the port's model.

The port keeps the JAX module's parameter names and layouts (Linear
weights ``[in, out]``), so the bridge is a checked, name-for-name copy.
It takes plain numpy arrays — the caller exports them on the JAX side,
e.g. ``{n: p.numpy() for n, p in jax_model.named_parameters()}`` — and
never imports the JAX package itself.
"""
import numpy as np
import torch

__all__ = ["load_jax_params"]


@torch.no_grad()
def load_jax_params(model, arrays):
    """Copy ``arrays`` (``{name: np.ndarray}``, the JAX model's
    parameter names) into ``model``'s parameters, cast to each
    parameter's dtype and device. Raises KeyError on a missing or an
    extra name and ValueError on a shape mismatch, before anything is
    copied. Returns ``model``."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(arrays[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {shape} does not match the "
                             f"port's {tuple(p.shape)}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if a.dtype.name == "bfloat16":     # ml_dtypes: torch has no view
            a = a.astype(np.float32)
        src = torch.from_numpy(np.array(a))        # a writable copy
        p.copy_(src.to(device=p.device, dtype=p.dtype))
    return model

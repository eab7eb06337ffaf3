"""Copy a JAX-package model's parameters, and an optimizer's state,
into the port, and back out.

The port keeps the JAX module's parameter names and layouts (Linear
weights ``[in, out]``), so the bridge is a checked, name-for-name copy.
It takes and gives plain numpy arrays — the caller exports them on the
JAX side, e.g. ``{n: p.numpy() for n, p in jax_model.named_parameters()}``
— and never imports the JAX package itself. An optimizer's state
crosses in the layout of both packages' ``state_dict()``: ``{"step",
"state": {state name ("m", "v", "master", "velocity", ...): {str(index
of the parameter): array}}, "LR_Scheduler": the scheduler's state}``,
so a run can take steps in one package and go on in the other.
"""
import numpy as np
import torch

__all__ = ["load_jax_params", "export_params", "export_optimizer_state",
           "load_optimizer_state"]


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


@torch.no_grad()
def export_params(model):
    """``{name: np.ndarray}`` of ``model``'s parameters on the host, the
    inverse of ``load_jax_params`` (so trained weights can be compared
    name for name). bf16 parameters come out as float32 (numpy has no
    bfloat16; the widening is exact)."""
    return {name: _host(p) for name, p in model.named_parameters()}


def _host(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def export_optimizer_state(optimizer):
    """``optimizer.state_dict()`` with every tensor as a numpy array on
    the host (bf16 widened to float32, exactly)."""
    sd = optimizer.state_dict()
    out = {"step": sd["step"]}
    if "state" in sd:
        out["state"] = {n: {k: _host(t) for k, t in st.items()}
                        for n, st in sd["state"].items()}
    if "LR_Scheduler" in sd:
        out["LR_Scheduler"] = dict(sd["LR_Scheduler"])
    return out


@torch.no_grad()
def load_optimizer_state(optimizer, state):
    """Load ``state`` (the layout of ``export_optimizer_state``, or a
    JAX-package optimizer's ``state_dict()`` exported to numpy) into
    ``optimizer``: each array onto its parameter's device, as f32 for the
    ``master`` tree and moments of low-precision parameters, else in the
    parameter's type (``_zeros_tree``'s rule). Returns ``optimizer``."""
    params = optimizer._parameters
    sd = {"step": int(state.get("step", 0))}
    if "state" in state:
        sd["state"] = {}
        for n, st in state["state"].items():
            tree = {}
            for k, a in st.items():
                p = params[int(k)]
                low = p.dtype in (torch.float16, torch.bfloat16)
                dt = torch.float32 if n == "master" or low else p.dtype
                a = np.asarray(a)
                if a.dtype.name == "bfloat16":
                    a = a.astype(np.float32)
                tree[k] = torch.from_numpy(np.array(a)).to(device=p.device,
                                                           dtype=dt)
            sd["state"][n] = tree
    if "LR_Scheduler" in state:
        sd["LR_Scheduler"] = dict(state["LR_Scheduler"])
    optimizer.set_state_dict(sd)
    return optimizer

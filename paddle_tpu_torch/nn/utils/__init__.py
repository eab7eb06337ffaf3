"""paddle.nn.utils: port of ``paddle_tpu/nn/utils/__init__.py`` (the
weight-norm and spectral-norm reparameterisations and the parameter
vector utilities).

``weight_norm`` and ``spectral_norm`` rewrite a layer as the reference
does: the original parameter leaves ``_parameters``, its replacements
(``<name>_g`` and ``<name>_v``, or ``<name>_orig`` and a
``<name>_spectral_norm`` sublayer) join, and a forward pre-hook sets
``layer.<name>`` to the derived weight before each call, so gradients
reach the new parameters. The vector utilities take torch parameters or
paddle ``Tensor``s and return the kind they were given.
"""
import torch

from ...core.tensor import Tensor, unwrap, wrap

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_"]


def _norm_except(w, dim):
    """``sqrt(sum(w ** 2))`` over every axis but ``dim`` (all of them for
    None), kept as size-1 axes."""
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(w.square().sum(axes, keepdim=True)) if axes else \
        w.abs()


def _weight_norm_value(v, g, dim):
    return g * v / (_norm_except(v, dim) + 1e-12)


def weight_norm(layer, name="weight", dim=0):
    """``layer.<name>`` becomes ``g * v / ||v||`` (norms over every axis
    but ``dim``; ``dim=None``: one scalar norm), recomputed before each
    call from the parameters ``<name>_g`` and ``<name>_v``."""
    from ..layer import Layer, ParamBase
    assert isinstance(layer, Layer)
    w = getattr(layer, name).detach()
    layer.add_parameter(name + "_g", ParamBase(_norm_except(w, dim)))
    layer.add_parameter(name + "_v", ParamBase(w.clone()))
    del layer._parameters[name]

    def _recompute(lyr, inputs):
        setattr(lyr, name, _weight_norm_value(getattr(lyr, name + "_v"),
                                              getattr(lyr, name + "_g"),
                                              dim))

    handle = layer.register_forward_pre_hook(_recompute)
    layer._weight_norm_hook = (handle, name, dim)
    _recompute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g * v / ||v||`` back into a plain parameter and drop the
    hook."""
    from ..layer import ParamBase
    handle, pname, dim = layer._weight_norm_hook
    if pname != name:
        raise ValueError(f"weight_norm was registered on {pname!r}")
    handle.remove()
    with torch.no_grad():
        eff = _weight_norm_value(getattr(layer, name + "_v"),
                                 getattr(layer, name + "_g"), dim)
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, ParamBase(eff))
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    del layer._weight_norm_hook
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``layer.<name>`` becomes ``<name>_orig / sigma`` through an
    ``nn.SpectralNorm`` sublayer, before each call. ``dim=None``: 1 for
    ``Linear`` and the transposed convolutions (their output axis), else
    0."""
    from ..layers_basic import (Conv1DTranspose, Conv2DTranspose,
                                Conv3DTranspose, Linear, SpectralNorm)
    w = getattr(layer, name)
    if dim is None:
        dim = 1 if isinstance(layer, (Linear, Conv1DTranspose,
                                      Conv2DTranspose,
                                      Conv3DTranspose)) else 0
    sn = SpectralNorm(list(w.shape), dim=dim, power_iters=n_power_iterations,
                      eps=eps).to(w.device)
    layer.add_sublayer(name + "_spectral_norm", sn)
    layer.add_parameter(name + "_orig", layer._parameters[name])
    del layer._parameters[name]

    def _recompute(lyr, inputs):
        setattr(lyr, name, sn(getattr(lyr, name + "_orig")))

    layer.register_forward_pre_hook(_recompute)
    _recompute(layer, None)
    return layer


def parameters_to_vector(parameters, name=None):
    parameters = list(parameters)
    out = torch.cat([unwrap(p).reshape(-1) for p in parameters])
    return wrap(out) if any(isinstance(p, Tensor) for p in parameters) \
        else out


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    v = unwrap(vec)
    off = 0
    for p in parameters:
        n = unwrap(p).numel()
        piece = v[off:off + n].reshape(unwrap(p).shape)
        if isinstance(p, Tensor):
            p.set_value(piece)
        else:
            p.copy_(piece)
        off += n


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every gradient in place by ``min(max_norm / (total + 1e-6),
    1)``, ``total`` the ``norm_type`` norm of all of them; returns
    ``total``."""
    if isinstance(parameters, (Tensor, torch.Tensor)):
        parameters = [parameters]
    parameters = list(parameters)
    paddle = any(isinstance(p, Tensor) for p in parameters)
    grads = [unwrap(p).grad for p in parameters
             if unwrap(p).grad is not None]
    if not grads:
        total = torch.zeros(())
        return wrap(total) if paddle else total
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite grad norm")
    scale = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return wrap(total) if paddle else total

"""``torch.export`` archives: the serialization format of the inference
engine.

Port of ``paddle_tpu/inference/export.py``. The reference's artifact is
a ``jax.export`` StableHLO archive with the weights baked in as
constants; the port's is a ``torch.export`` archive (``torch.export.
save``) with the weights and buffers inside it, plus the reference's
JSON sidecar:

- ``<prefix>.pdmodel``: the exported program;
- ``<prefix>.pdmeta``: ``{"format": "paddle_tpu_torch-export-v1",
  "feed_names", "fetch_names", "feed_specs"}``, each feed spec
  ``{"name", "shape" (-1 for a dynamic dim), "dtype"}``.

Neither package loads the other's archive: ``load_exported`` refuses a
sidecar of another format by name. A program exported on the card runs
the port's hand-written forward kernels through their custom ops
(``ops.kernels.custom_ops``: K4a, K5a, K6, K7, K8), never a plain
version; loading imports ``paddle_tpu_torch.ops.kernels``, which
registers them, where the reference's loader needs only jax.
``export_program`` exports a ``static.Program`` (``save_inference_
model``), ``export_layer`` an eager layer (``jit.save``).
"""
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..nn.layer import plain_parameters
from ..static import InputSpec, _dtype

__all__ = ["FORMAT", "ExportedProgram", "export_layer", "export_program",
           "load_exported"]

FORMAT = "paddle_tpu_torch-export-v1"


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _device_of(module):
    """The device of a module's first parameter or buffer (the default
    place if it holds none)."""
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    from ..device import default_device
    return default_device()


def _feeds(input_spec, device):
    """(examples, feed names, dynamic shapes, feed specs) of ``export_
    layer``'s ``input_spec``: an ``InputSpec`` traces with a zero example
    whose dynamic dims are ``DYNAMIC_EXAMPLE_SIZE`` and become
    ``torch.export.Dim``s named per feed and axis (``f{i}_dyn{j}``, so two
    feeds' dims stay apart, as the reference's ``prefix`` keeps its
    symbols apart); a tensor or array is a concrete example at its own
    shape."""
    examples, names, dyn, specs = [], [], [], []
    for i, spec in enumerate(input_spec):
        if isinstance(spec, InputSpec):
            ex = spec.example(device)
            name = spec.name or f"input_{i}"
            dims = {j: torch.export.Dim(f"f{i}_dyn{j}", min=1)
                    for j in spec.dynamic_dims()}
        else:
            ex = spec if torch.is_tensor(spec) \
                else torch.from_numpy(np.ascontiguousarray(spec))
            ex = ex.to(device)
            name, dims = f"input_{i}", {}
        examples.append(ex)
        names.append(name)
        dyn.append(dims or None)
        specs.append({"name": name,
                      "shape": [-1 if j in dims else int(d)
                                for j, d in enumerate(ex.shape)],
                      "dtype": _dtype_name(ex.dtype)})
    return examples, names, dyn, specs


def _write(path_prefix, ep, feed_names, fetch_names, feed_specs):
    os.makedirs(os.path.dirname(os.path.abspath(path_prefix)), exist_ok=True)
    _save_program(ep, path_prefix + ".pdmodel")
    meta = {"format": FORMAT, "feed_names": feed_names,
            "fetch_names": fetch_names, "feed_specs": feed_specs}
    with open(path_prefix + ".pdmeta", "w") as f:
        json.dump(meta, f)


def _save_program(ep, path):
    """``torch.export.save`` to ``path`` through a file object (the
    archive's suffix is the reference's, not ``.pt2``)."""
    with open(path, "wb") as f:
        torch.export.save(ep, f)


def _export(module, examples, dynamic_shapes=None):
    """``torch.export.export`` of ``module`` in inference: no autograd
    graph, no gradient state in the program."""
    with torch.no_grad(), plain_parameters(module):
        return torch.export.export(module, tuple(examples),
                                   dynamic_shapes=dynamic_shapes)


class _ProgramModule(torch.nn.Module):
    """A static program's inference function as a module: the scope's
    values it reads are its buffers, ``forward(*feeds)`` replays the
    pruned ops (``static._program_infer_fn``)."""

    def __init__(self, fn, values):
        super().__init__()
        self._fn = fn
        self._names = list(values)
        for i, v in enumerate(values.values()):
            self.register_buffer(f"var{i}", v)

    def forward(self, *feeds):
        values = {n: getattr(self, f"var{i}")
                  for i, n in enumerate(self._names)}
        return tuple(self._fn(values, *feeds))


def export_program(path_prefix, program, feed_names, fetch_names, scope):
    """Export a static ``Program``'s ``feeds -> fetches`` function (the
    ``save_inference_model`` path): the ops the fetches need, replayed
    under ``torch.export`` with the scope's values inside, on their
    device. A feed declared by ``static.data`` with ``-1`` dims exports
    them as ``torch.export.Dim``s."""
    from ..static import _program_infer_fn
    fn, values = _program_infer_fn(program, feed_names, fetch_names, scope)
    values = {n: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
              for n, v in values.items()}
    device = next((v.device for v in values.values()), None)
    if device is None:
        from ..device import default_device
        device = default_device()
    values = {n: v.detach().to(device) for n, v in values.items()}
    block = program.global_block
    specs = []
    for n in feed_names:
        var = block.vars[n]
        spec = getattr(var, "_input_spec", None)
        shape = spec.shape if spec is not None else list(var._value.shape)
        specs.append(InputSpec(shape, _dtype_name(var._value.dtype), n))
    examples, names, dyn, feed_specs = _feeds(specs, device)
    # forward(*feeds): the dims of the feeds nest in one tuple
    ep = _export(_ProgramModule(fn, values), examples,
                 (tuple(dyn),) if any(d is not None for d in dyn) else None)
    _write(path_prefix, ep, names, list(fetch_names), feed_specs)


def export_layer(path_prefix, layer, input_spec):
    """Export an eager layer's forward (the ``jit.save`` path): a
    ``torch.export`` archive of ``layer(*feeds)`` in eval mode with its
    parameters and buffers inside, traced on the layer's device. Feeds
    are ``InputSpec``s (a ``-1``/``None`` dim is dynamic) or concrete
    example tensors or arrays. Every module's ``training`` flag is put
    back afterwards, whatever export did. On the card the program holds
    the forward kernels' custom ops."""
    modules = list(layer.modules())
    was_training = [(m, m.training) for m in modules]
    device = _device_of(layer)
    examples, names, dyn, specs = _feeds(input_spec, device)
    layer.eval()
    try:
        ep = _export(layer, examples,
                     dyn if any(d is not None for d in dyn) else None)
    finally:
        for m, flag in was_training:
            m.training = flag
    _write(path_prefix, ep, names,
           [f"output_{i}"
            for i in range(len(ep.graph_signature.user_outputs))], specs)


def _load_program(path, device):
    """``torch.export.load`` of ``path`` with the custom ops registered,
    its weights moved to ``device`` when they lie elsewhere."""
    from ..ops import kernels  # noqa: F401  (registers the custom ops)
    with open(path, "rb") as f:
        ep = torch.export.load(f)
    held = next(iter(ep.state_dict.values()), None)
    if held is None:
        held = next((c for c in ep.constants.values() if torch.is_tensor(c)),
                    None)
    if held is not None and not _same_device(held.device, device):
        ep = torch.export.passes.move_to_device_pass(ep, device)
    return ep


def _same_device(a, b):
    """Whether ``a`` is ``b``, a ``b`` without an index meaning the
    current device of its type."""
    if a.type != b.type:
        return False
    if b.type != "cuda":
        return True
    want = torch.cuda.current_device() if b.index is None else b.index
    return a.index == want


def _read_meta(path, fmt):
    with open(path) as f:
        meta = json.load(f)
    if meta.get("format") != fmt:
        raise ValueError(
            f"{path} holds a {meta.get('format')!r} archive, not {fmt!r}: "
            f"the JAX package's archives are jax.export StableHLO, which "
            f"torch cannot load (export the model again with the port)")
    return meta


class ExportedProgram:
    """Callable handle over a loaded archive: ``prog(*inputs)`` takes
    tensors or arrays (moved to the program's device and cast to each
    feed's dtype) and returns the program's outputs as tensors on its
    device."""

    def __init__(self, program, meta, device):
        self.program = program                 # torch.export's program
        self._module = program.module()
        self.meta = meta
        self.device = device
        self.feed_names = meta["feed_names"]
        self.fetch_names = meta["fetch_names"]
        self.feed_specs = meta["feed_specs"]
        self._dtypes = [_dtype(s["dtype"]) for s in self.feed_specs]

    def __call__(self, *inputs):
        vals = []
        for x, dt in zip(inputs, self._dtypes):
            t = x if torch.is_tensor(x) \
                else torch.from_numpy(np.ascontiguousarray(x))
            vals.append(t.to(self.device, dt))
        with torch.no_grad():
            return self._module(*vals)

    def run(self, feed):
        return self(*[feed[n] for n in self.feed_names])


def load_exported(path_prefix, device=None):
    """Load ``<prefix>.pdmodel`` / ``.pdmeta``: ``(program, feed_names,
    fetch_names)``. ``device=None`` means the card (raises without one);
    the weights move there if the archive was saved elsewhere."""
    dev = resolve_device(device)
    meta = _read_meta(path_prefix + ".pdmeta", FORMAT)
    prog = ExportedProgram(_load_program(path_prefix + ".pdmodel", dev),
                           meta, dev)
    return prog, prog.feed_names, prog.fetch_names

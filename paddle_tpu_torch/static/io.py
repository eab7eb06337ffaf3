"""Saving and loading programs: ``save_inference_model`` /
``load_inference_model`` over the port's ``torch.export`` archives,
``save`` / ``load`` of a program's persistable variables,
``set_program_state`` / ``load_program_state``, and the
``serialize_*`` / ``deserialize_*`` functions.

Port of ``paddle_tpu/static/io.py``. An inference archive is
``inference.export_program``'s (the ``.pdmodel`` / ``.pdmeta`` pair of
``export_layer``), which ``load_inference_model``, ``jit.load`` and the
``Predictor`` read; on the card it holds the forward kernels' custom
ops. Parameters are saved in the JAX package's pickle format
(``io.save``).
"""
import pickle

import numpy as np
import torch

from ..core.tensor import as_value
from ..device import default_device
from .executor import global_scope
from .graph import default_main_program

__all__ = ["save_inference_model", "load_inference_model", "save", "load",
           "set_program_state", "load_program_state", "serialize_program",
           "serialize_persistables", "save_to_file", "load_from_file",
           "deserialize_program", "deserialize_persistables",
           "normalize_program"]


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Export the program's ``feed_vars -> fetch_vars`` function, pruned
    to what the fetches need, with the scope's values inside
    (``<prefix>.pdmodel`` / ``.pdmeta``)."""
    from ..inference.export import export_program
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    if program is None:
        owner = getattr(feed_vars[0], "block", None)
        program = owner.program if owner is not None \
            else default_main_program()
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    export_program(path_prefix, program, [v.name for v in feed_vars],
                   [v.name for v in fetch_vars], global_scope())


def load_inference_model(path_prefix, executor=None, device=None, **kwargs):
    """``(program, feed_names, fetch_names)``: ``program(*feeds)`` runs
    the archive on ``device`` (None: the executor's device, else the
    default place)."""
    from ..inference.export import load_exported
    if device is None:
        device = executor.device if executor is not None \
            else default_device()
    return load_exported(path_prefix, device=device)


def _persistables(program):
    scope = global_scope()
    return {n: scope._vars[n] for n, v in program.global_block.vars.items()
            if v.persistable and n in scope._vars}


def save(program, path_prefix):
    """Persist every persistable variable of ``program``
    (``<prefix>.pdparams``)."""
    from ..io.save_load import save as _save
    _save({n: torch.as_tensor(v) for n, v in _persistables(program).items()},
          path_prefix + ".pdparams")


def _set_scope(state):
    scope = global_scope()
    for n, v in state.items():
        old = scope._vars.get(n)
        dev = old.device if torch.is_tensor(old) else default_device()
        scope._vars[n] = as_value(v, device=dev)


def load(program, path_prefix, executor=None, var_list=None):
    from ..io.save_load import load as _load
    _set_scope(_load(path_prefix + ".pdparams"))


def set_program_state(program, state_dict):
    _set_scope(state_dict)


def serialize_program(feed_vars, fetch_vars, program=None, **kwargs):
    program = program or default_main_program()
    return pickle.dumps({
        "version": 1,
        "feeds": [v.name for v in feed_vars],
        "fetches": [v.name for v in fetch_vars],
        "desc": [(op.op_type, [getattr(i, "name", None) for i in op.inputs],
                  list(op.outputs))
                 for op in program.global_block.ops],
    })


def _host(v):
    from ..core.tensor import Tensor
    return Tensor(v).numpy() if torch.is_tensor(v) else np.asarray(v)


def serialize_persistables(feed_vars, fetch_vars, executor=None,
                           program=None, **kwargs):
    scope = global_scope()
    return pickle.dumps({n: _host(scope._vars[n])
                         for n in scope.local_var_names()})


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data):
    return pickle.loads(data)


def deserialize_persistables(program, data, executor=None):
    state = pickle.loads(data)
    scope = global_scope()
    for name, val in state.items():
        scope.var(name).set(val)
    return state


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """Record the program's endpoints (the passes root the fetches); the
    Executor prunes nothing, so the program stays as it is otherwise."""
    program._normalized_feeds = [v.name for v in feed_vars]
    program._normalized_fetches = [v.name for v in fetch_vars]
    return program


def load_program_state(model_path, var_list=None):
    from ..io.save_load import load as _load
    return _load(model_path if model_path.endswith(".pdparams")
                 else model_path + ".pdparams")

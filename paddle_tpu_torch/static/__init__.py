"""``paddle.static``: the define-and-run API over the port.

Port of ``paddle_tpu/static`` (item 15.5). A ``Program`` records the
ops that touch symbolic ``Variable``s (``graph.py``); ``Executor``
replays it eagerly on the card, its gradients by torch autograd and its
training by the optimizer's functional update (``executor.py``); the
passes shrink it (``passes.py``); ``save_inference_model`` exports it
as a ``torch.export`` archive (``io.py``, ``inference.export``). The
layout mirrors the reference: ``program.py`` (the builders), ``io.py``,
``device.py``, ``metrics.py``, ``nn``, ``passes``. ``collective`` is not
ported (ROADMAP, Queue 1 item 13).
"""
from . import collective  # noqa: F401
from . import nn  # noqa: F401
from . import passes  # noqa: F401
from .device import *  # noqa: F401,F403
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .graph import (Program, Variable, VarRef, default_main_program,  # noqa: F401
                    default_startup_program, in_static_build, program_guard)
from .io import *  # noqa: F401,F403
from .metrics import *  # noqa: F401,F403
from .passes import apply_build_strategy, apply_pass  # noqa: F401
from .program import *  # noqa: F401,F403
from .program import _dtype, _program_infer_fn, _prune_ops  # noqa: F401

__all__ = [
    "Program", "Variable", "Executor", "Scope", "global_scope",
    "scope_guard", "program_guard", "default_main_program",
    "default_startup_program", "data", "InputSpec", "create_parameter",
    "create_global_var", "append_backward", "gradients",
    "save_inference_model", "load_inference_model", "save", "load",
    "CompiledProgram", "cpu_places", "device_guard", "name_scope", "nn",
]

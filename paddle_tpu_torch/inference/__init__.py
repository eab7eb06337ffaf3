"""paddle_tpu_torch.inference — the deployment and serving engine.

Port of ``paddle_tpu/inference/__init__.py``: the paddle_infer surface
(``Config``, ``create_predictor``, ``Predictor`` with its zero-copy style
handles, ``convert_to_mixed_precision``) over ``torch.export`` archives
(``export.py``), the generation archives (``deploy_decode.py``), the
decode loops (``decode_loop.py``: greedy, sampled, beam, constrained,
``scan_decode``) and ``speculative_generate``; and the serving stack:
the continuous-batching server over the paged KV pool, its host-side
page allocator, its radix prefix cache and host KV tier, the fleet
(``ReplicaRouter`` over server replicas in process or behind the wire —
``ReplicaHost``, ``RemoteReplica``, ``spawn_replica_host`` — and
disaggregated placement), the ``BatchScheduler`` and ``serve_metrics``,
the HTTP exposition of their telemetry. ``export_program`` exports a
``static.Program`` (``static.save_inference_model``).
"""
import copy
import time

import numpy as np
import torch

from .export import (ExportedProgram, export_layer, export_program,
                     load_exported)

__all__ = ["Config", "Predictor", "create_predictor", "Tensor",
           "export_program", "export_layer", "load_exported",
           "ExportedProgram", "convert_to_mixed_precision", "get_version",
           # serving stack (beyond the reference surface)
           "BatchScheduler", "ContinuousBatchingServer", "PreemptionPolicy",
           "PoolBalance", "PagedKVCache", "OutOfPages", "NULL_PAGE",
           "PrefixCache", "PrefixMatch", "prefix_fingerprints", "HostTier",
           "ReplicaRouter", "RouterSupervisor", "ReplicaHost",
           "RemoteReplica", "spawn_replica_host", "placement",
           "serve_metrics", "scan_decode", "greedy_generate",
           "sample_generate", "beam_generate", "fsm_generate",
           "phrases_to_fsm", "process_logits", "speculative_generate",
           "export_decode", "load_decode", "DeployedGenerator"]


def get_version():
    from .. import __version__
    return __version__


class Config:
    """paddle_infer.Config parity: the archive's path and the execution
    switches. ``enable_use_gpu(device_id=)`` runs the predictor on
    ``cuda:<device_id>`` (the default: ``cuda:0``, which raises without a
    card), ``disable_gpu()`` on the CPU; the memory pool size is the
    caching allocator's concern and is only recorded."""

    def __init__(self, prog_file=None, params_file=None):
        # paddle convention: Config("path/prefix") or Config(model, params)
        self._path_prefix = None
        if prog_file is not None:
            self._path_prefix = str(prog_file)
            for suf in (".pdmodel", ".pdiparams"):
                if self._path_prefix.endswith(suf):
                    self._path_prefix = self._path_prefix[: -len(suf)]
        self._device = "cuda:0"
        self._memory_pool_mb = None
        self._enable_profile = False
        self._memory_optim = False

    def set_model(self, prog_file, params_file=None):
        self.__init__(prog_file, params_file)

    def model_dir(self):
        return self._path_prefix

    def prog_file(self):
        return (self._path_prefix or "") + ".pdmodel"

    # functional switches ------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._memory_pool_mb = memory_pool_init_size_mb
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def enable_memory_optim(self):
        """Accepted and recorded. The reference donates the feed buffers
        to its compiled call; an exported torch program allocates its
        outputs anew and has no donation to switch on, so this changes
        nothing (ROADMAP Queue 3)."""
        self._memory_optim = True

    def switch_ir_optim(self, flag=True):
        """The exported program runs as it was captured, its kernels the
        hand-written ones; there is no other execution path to switch
        to, so disabling raises instead of sitting inert (as the
        reference's does)."""
        if not flag:
            # no-roadmap: deliberate API refusal, not a scope cut
            raise NotImplementedError(
                "switch_ir_optim(False): the exported program has no "
                "unoptimized form to run; inspect the captured graph "
                "with load_exported(prefix)[0].program.graph")

    def enable_profile(self):
        """Per-run wall-time stats exposed via profile_stats()."""
        self._enable_profile = True
        self._profile = {"runs": 0, "total_ms": 0.0}

    def profile_stats(self):
        return dict(getattr(self, "_profile", {"runs": 0, "total_ms": 0.0}))

    def set_cpu_math_library_num_threads(self, n):
        # the reference's MKL knob: recorded for summary()
        self._cpu_threads = int(n)

    def summary(self):
        return {"model": self.prog_file(), "backend": "torch.export",
                "device": self._device, "memory_optim": self._memory_optim,
                "profile": self._enable_profile}


class Tensor:
    """Zero-copy style IO handle (paddle_infer.Tensor parity): numpy
    values in and out."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def copy_from_cpu(self, data):
        self._value = np.ascontiguousarray(data)

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def shape(self):
        return list(self._value.shape) if self._value is not None else None


def _to_numpy(t):
    """An output tensor as numpy on the host. numpy has no bfloat16: a
    bf16 output is copied out as float32 (exactly)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class Predictor:
    """A loaded archive (``load_exported``) on the config's device. Calls
    from several threads may share one predictor: a run holds no state
    but its own handles' values."""

    def __init__(self, config):
        self.config = config
        prog, feeds, fetches = load_exported(config._path_prefix,
                                             device=config._device)
        self._prog = prog
        self._inputs = {n: Tensor(n) for n in feeds}
        self._outputs = {n: Tensor(n) for n in fetches}

    def get_input_names(self):
        return list(self._inputs)

    def get_output_names(self):
        return list(self._outputs)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_input_tensor(self, name):
        return self._inputs[name]

    def get_output_handle(self, name):
        return self._outputs[name]

    def get_output_tensor(self, name):
        return self._outputs[name]

    def run(self, inputs=None):
        """Either a positional list of arrays (returns the list of output
        arrays) or, with no argument, the input handles' values into the
        output handles (returns True)."""
        t0 = time.perf_counter() \
            if getattr(self.config, "_enable_profile", False) else None
        vals = inputs if inputs is not None \
            else [self._inputs[n]._value for n in self._inputs]
        outs = self._prog(*vals)
        flat = [_to_numpy(o) for o in
                (outs if isinstance(outs, (list, tuple)) else [outs])]
        if inputs is not None:
            res = flat
        else:
            for t, v in zip(self._outputs.values(), flat):
                t._value = v
            res = True
        if t0 is not None:
            self.config._profile["runs"] += 1
            self.config._profile["total_ms"] += \
                (time.perf_counter() - t0) * 1e3
        return res


def create_predictor(config):
    return Predictor(config)


_MIXED = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
          "fp16": torch.float16, "float16": torch.float16}


class _CastOutputs(torch.nn.Module):
    """A loaded program whose floating outputs are cast to ``dtype``."""

    def __init__(self, inner, dtype):
        super().__init__()
        self.inner = inner
        self.dtype = dtype

    def forward(self, *xs):
        out = self.inner(*xs)
        if torch.is_tensor(out):
            return self._cast(out)
        return type(out)(self._cast(t) for t in out)

    def _cast(self, t):
        return t.to(self.dtype) if t.is_floating_point() else t


def convert_to_mixed_precision(src_prefix, dst_prefix, mixed_precision="bf16",
                               backend=None, model=None, input_spec=None,
                               device=None, **kwargs):
    """Re-export an inference archive in mixed precision (reference:
    paddle.inference.convert_to_mixed_precision).

    - ``model`` given (the layer the archive was exported from, or an
      equivalent): a deep copy with every floating parameter cast to the
      target dtype (buffers as they are, as the reference's ``astype``)
      is exported to ``dst_prefix`` with ``input_spec`` (by default the
      source archive's feed specs).
    - archive-only: the archive's weights are final, so the converted
      archive wraps the loaded program (on ``device``; None means the
      card) with its floating outputs cast to the target dtype; the
      feeds keep their dtypes.
    """
    from ..static import InputSpec
    from .export import (FORMAT, _export, _feeds, _load_program, _read_meta,
                         _write)
    from ..device import resolve_device

    dt = _MIXED.get(mixed_precision)
    if dt is None:
        raise ValueError(f"mixed_precision must be one of {sorted(_MIXED)}, "
                         f"got {mixed_precision!r}")
    if model is not None:
        m = copy.deepcopy(model)
        with torch.no_grad():
            for p in m.parameters():
                if p.is_floating_point() and p.dtype != dt:
                    p.data = p.data.to(dt)
        if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
            m.dtype = dt
        if input_spec is None:
            meta = _read_meta(src_prefix + ".pdmeta", FORMAT)
            input_spec = [InputSpec(shape=s["shape"], dtype=s["dtype"],
                                    name=s["name"])
                          for s in meta["feed_specs"]]
        export_layer(dst_prefix, m, input_spec)
        return dst_prefix

    dev = resolve_device(device)
    meta = _read_meta(src_prefix + ".pdmeta", FORMAT)
    prog = _load_program(src_prefix + ".pdmodel", dev)
    specs = [InputSpec(shape=s["shape"], dtype=s["dtype"], name=s["name"])
             for s in meta["feed_specs"]]
    examples, names, dyn, feed_specs = _feeds(specs, dev)
    # forward(*xs): the dynamic shapes nest one level, as the feeds do
    ep = _export(_CastOutputs(prog.module(), dt), examples,
                 (tuple(dyn),) if any(d is not None for d in dyn) else None)
    _write(dst_prefix, ep, names, meta["fetch_names"], feed_specs)
    return dst_prefix


from . import placement  # noqa: E402,F401  (disaggregated serving policy)
from .continuous_batching import (ContinuousBatchingServer,  # noqa: E402
                                  PoolBalance, PreemptionPolicy)
from .decode_loop import (beam_generate, fsm_generate,  # noqa: E402
                          greedy_generate, phrases_to_fsm, process_logits,
                          sample_generate, scan_decode)
from .deploy_decode import (DeployedGenerator, export_decode,  # noqa: E402
                            load_decode)
from .kv_cache import NULL_PAGE, OutOfPages, PagedKVCache  # noqa: E402
from .kv_tier import HostTier  # noqa: E402
from .prefix_cache import (PrefixCache, PrefixMatch,  # noqa: E402
                           prefix_fingerprints)
from .remote import (RemoteReplica, ReplicaHost,  # noqa: E402
                     spawn_replica_host)
from .router import ReplicaRouter, RouterSupervisor  # noqa: E402
from .serving import BatchScheduler, serve_metrics  # noqa: E402
from .speculative import speculative_generate  # noqa: E402

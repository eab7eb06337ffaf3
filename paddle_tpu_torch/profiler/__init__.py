"""paddle.profiler parity over ``torch.profiler``.

Port of ``paddle_tpu/profiler/__init__.py`` (reference:
python/paddle/profiler/profiler.py:79 ProfilerTarget / states
CLOSED/READY/RECORD, :215 export_chrome_tracing, :650 scheduler). The
reference records through ``jax.profiler``; the port through
``torch.profiler.profile`` with the CPU activity and, when a card is
there, the CUDA one (CUPTI), so the trace holds the card's kernels by
name beside the host's ranges. The scheduler and its states, the step
API, ``RecordEvent`` (``torch.profiler.record_function``), the step
timer (``StepTimer``, ``publish_to`` a telemetry registry) and
``export_protobuf`` / ``load_profiler_result`` (the reference's JSON
pointer format) carry over. Each recorded window is written as a Chrome
trace (``trace_<n>.json``) into the directory ``export()`` returns.
"""
from __future__ import annotations

import contextlib
import os
import time

__all__ = ["Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "profiler_step_timer",
           "StepTimer"]


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"
    CUSTOM_DEVICE = "custom_device"


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """Reference profiler.py:650 — returns state per step index."""

    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        period = closed + ready + record
        if period <= 0:
            return ProfilerState.RECORD
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name, worker_name=None):
    """An ``on_trace_ready`` handler: the window's Chrome traces copied
    into ``dir_name``."""
    def handler(prof):
        prof.export(dir_name)
    return handler


class Profiler:
    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        self._scheduler = scheduler if callable(scheduler) else (
            make_scheduler(record=scheduler[1] - scheduler[0],
                           skip_first=scheduler[0])
            if isinstance(scheduler, (tuple, list)) else None)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._targets = targets
        self._options = {"record_shapes": record_shapes,
                         "profile_memory": profile_memory,
                         "with_flops": with_flops}
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._dir = None
        self._active = False
        self._prof = None
        self._traces = []
        self.timer = StepTimer()

    def _activities(self):
        """The CPU activity; the CUDA one too when a card is there and
        ``targets`` does not leave the GPU out."""
        import torch
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        want_gpu = self._targets is None or ProfilerTarget.GPU in \
            self._targets
        if want_gpu and torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def start(self):
        self.timer.start()
        if self._timer_only:
            return
        if self._scheduler is None:
            self._begin_trace()

    def _begin_trace(self):
        if not self._active:
            import tempfile
            import torch
            self._dir = self._dir or tempfile.mkdtemp(prefix="pt_prof_")
            self._prof = torch.profiler.profile(
                activities=self._activities(), **self._options)
            self._prof.__enter__()
            self._active = True

    def _end_trace(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._active = False
        path = os.path.join(self._dir, f"trace_{len(self._traces)}.json")
        self._prof.export_chrome_trace(path)
        self._traces.append(path)
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def stop(self):
        self.timer.stop()
        if self._active:
            self._end_trace()

    def step(self, num_samples=None):
        self._step += 1
        self.timer.step(num_samples)
        if self._timer_only or self._scheduler is None:
            return
        state = self._scheduler(self._step)
        if state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._begin_trace()
        elif self._active:
            self._end_trace()

    def export(self, path=None, format=None):  # noqa: A002
        """The directory holding the recorded windows' Chrome traces;
        with ``path``, the traces are copied into that directory first
        and it is returned."""
        if path is None or self._dir is None:
            return self._dir
        import shutil
        os.makedirs(path, exist_ok=True)
        for t in self._traces:
            shutil.copy(t, path)
        return path

    @property
    def trace_dir(self):
        """The directory of the Chrome traces (``export_protobuf`` points
        at it)."""
        return self._dir

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        t = self.timer
        if t.count:
            return (f"steps={t.count} avg_step_ms="
                    f"{1000*t.total_time/max(t.count,1):.2f} "
                    f"ips={t.ips():.1f}")
        return "no steps recorded"

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class RecordEvent:
    """Host-side named range (reference platform/profiler RecordEvent
    RAII) as ``torch.profiler.record_function``, so it lands in the
    trace beside the card's kernels."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._ctx = None

    def begin(self):
        import torch
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()

    def end(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *a):
        self.end()


class StepTimer:
    """Throughput reporter (reference python/paddle/profiler/timer.py used
    by fleet to report ips). ``publish_to(registry)`` bridges every
    ``step()`` into the telemetry subsystem (per-step histogram + ips
    gauge) at zero cost when unattached."""

    def __init__(self):
        self._tele = None
        self.reset()

    def reset(self):
        self.count = 0
        self.samples = 0
        self.total_time = 0.0
        self._t0 = None

    def publish_to(self, registry, prefix="step_timer"):
        """Publish ``<prefix>_seconds`` (histogram) and ``<prefix>_ips``
        (gauge) into a ``telemetry.MetricRegistry`` on every step()."""
        from ..telemetry.training import STEP_BUCKETS
        if registry.enabled:
            self._tele = (
                registry.histogram(f"{prefix}_seconds",
                                   "Per-step wall time",
                                   buckets=STEP_BUCKETS),
                registry.gauge(f"{prefix}_ips",
                               "Items (samples, else steps) per second"))
        return self

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.total_time += time.perf_counter() - self._t0
            self._t0 = None

    def step(self, num_samples=None):
        now = time.perf_counter()
        dt = None
        if self._t0 is not None:
            dt = now - self._t0
            self.total_time += dt
        self._t0 = now
        self.count += 1
        if num_samples:
            self.samples += num_samples
        if dt is not None and self._tele is not None:
            hist, gauge = self._tele
            hist.observe(dt)
            gauge.set(self.ips())

    def ips(self):
        if self.total_time <= 0:
            return 0.0
        base = self.samples if self.samples else self.count
        return base / self.total_time


@contextlib.contextmanager
def profiler_step_timer(registry=None, prefix="step_timer"):
    t = StepTimer()
    if registry is not None:
        t.publish_to(registry, prefix)
    t.start()
    yield t
    t.stop()


class SortedKeys:
    """Report sort keys (reference profiler/profiler_statistic.py)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView:
    """Report views (reference profiler/profiler.py SummaryView)."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(profiler_result, path):
    """Persist a captured result as the reference does: a JSON pointer
    to its trace directory (``Profiler.export()``)."""
    import json
    with open(path, "w") as f:
        json.dump({"format": "paddle_tpu-trace-pointer",
                   "trace_dir": getattr(profiler_result, "trace_dir",
                                        str(profiler_result))}, f)
    return path


def load_profiler_result(path):
    import json
    with open(path) as f:
        return json.load(f)

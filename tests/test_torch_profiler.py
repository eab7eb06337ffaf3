"""The port's ``profiler``, ``reader`` and ``cost_model`` against the JAX
package's, on the CPU.

- ``profiler``: ``tests/test_hapi_io.py``'s timer-and-events case on
  both packages; ``make_scheduler``'s states equal the reference's over a
  grid of arguments and steps; ``StepTimer.publish_to`` fills a telemetry
  registry as the reference's does; ``export_protobuf`` /
  ``load_profiler_result`` write and read the reference's JSON, each
  package reading the other's; a CPU trace (``torch.profiler`` under
  ``Profiler``) holds a ``RecordEvent`` range and the ops inside it, and
  a scheduled profiler records, exports and hands its window to
  ``on_trace_ready`` at the reference's steps;
- ``reader``: ``tests/test_parity_tail.py``'s reader cases on both
  packages, ``shuffle`` in the reference's order under one
  ``random.seed``;
- ``cost_model``: ``profile_measure`` and ``measure_program`` on the same
  static program built in both packages give the reference's numbers
  (``tests/test_parity_tail.py``'s case and
  ``tests/test_autoparallel_tuner.py``'s matmul/lookup split);
  ``xla_cost_analysis`` of a matmul counts ``2*M*N*K`` flops in both.
"""
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice

BOTH = pytest.mark.parametrize("m", [jt, pt], ids=["jax", "port"])


@pytest.fixture(scope="module")
def on_cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


# ------------------------------------------------------------ profiler

@BOTH
def test_profiler_timer_and_events(m, on_cpu):
    prof = m.profiler
    p = prof.Profiler(timer_only=True)
    p.start()
    for _ in range(3):
        with prof.RecordEvent("work"):
            _ = m.ones([10]).sum()
        p.step(num_samples=4)
    p.stop()
    assert p.timer.count == 3 and p.timer.samples == 12
    assert p.summary().startswith("steps=3 avg_step_ms=")
    assert p.export() is None                  # timer only: no trace


def test_make_scheduler_states_equal_the_references():
    for closed in (0, 1, 2):
        for ready in (0, 1):
            for record in (0, 1, 3):
                for repeat in (0, 2):
                    for skip in (0, 3):
                        kw = dict(closed=closed, ready=ready, record=record,
                                  repeat=repeat, skip_first=skip)
                        js = jt.profiler.make_scheduler(**kw)
                        ts = pt.profiler.make_scheduler(**kw)
                        assert [ts(i) for i in range(24)] == \
                            [js(i) for i in range(24)], kw
    for name in ("CLOSED", "READY", "RECORD", "RECORD_AND_RETURN"):
        assert getattr(pt.profiler.ProfilerState, name) == \
            getattr(jt.profiler.ProfilerState, name)


def _publish(m):
    from importlib import import_module
    reg = import_module(f"{m.__name__}.telemetry").MetricRegistry()
    t = m.profiler.StepTimer().publish_to(reg, prefix="st")
    t.start()
    for _ in range(3):
        t.step(num_samples=2)
    t.stop()
    snap = reg.snapshot()
    return (t.count, t.samples, snap["st_seconds"]["samples"][()]["count"],
            sorted(snap), snap["st_ips"]["samples"][()] > 0)


def test_step_timer_publishes_as_the_reference():
    assert _publish(pt) == _publish(jt)
    assert _publish(pt)[:3] == (3, 6, 3)


def test_export_protobuf_round_trips_between_the_packages(tmp_path):
    class Result:
        trace_dir = "/traces/run1"

    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert pt.profiler.export_protobuf(Result(), a) == a
    jt.profiler.export_protobuf(Result(), b)
    with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb)
    assert jt.profiler.load_profiler_result(a) == \
        pt.profiler.load_profiler_result(b) == {
            "format": "paddle_tpu-trace-pointer", "trace_dir": "/traces/run1"}


def _trace_events(d):
    events = []
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f)) as fh:
            events += json.load(fh)["traceEvents"]
    return events


def test_cpu_trace_holds_the_record_event_and_its_ops(on_cpu, tmp_path):
    prof = pt.profiler
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU])
    with p:
        with prof.RecordEvent("port_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    d = p.export()
    assert os.listdir(d) == ["trace_0.json"]
    events = _trace_events(d)
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    assert [e["name"] for e in ranges] == ["port_range"]
    r = ranges[0]
    inside = [e["name"] for e in events if e.get("cat") == "cpu_op"
              and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
    assert "aten::matmul" in inside
    out = str(tmp_path / "copy")
    assert p.export(out) == out and os.listdir(out) == ["trace_0.json"]
    assert pt.profiler.load_profiler_result(pt.profiler.export_protobuf(
        p, str(tmp_path / "p.json")))["trace_dir"] == d


def test_scheduled_profiler_records_the_references_window(on_cpu, tmp_path):
    """``make_scheduler(closed=1, record=2, repeat=1)``: steps 1 and 2
    are recorded (the reference's states), the window ends at step 3 and
    goes to ``on_trace_ready``, here ``export_chrome_tracing``."""
    ready = []
    handler = pt.profiler.export_chrome_tracing(str(tmp_path / "out"))

    def on_ready(prof):
        ready.append(prof._step)
        handler(prof)

    kw = dict(closed=1, record=2, repeat=1)
    p = pt.profiler.Profiler(scheduler=pt.profiler.make_scheduler(**kw),
                             on_trace_ready=on_ready)
    states = []
    with p:
        for i in range(5):
            with pt.profiler.RecordEvent(f"step{i}"):
                torch.ones(8).sum()
            p.step()
            states.append(p._active)
    sched = jt.profiler.make_scheduler(**kw)
    assert states == [sched(i) != 0 for i in range(1, 6)] == \
        [True, True, False, False, False]
    assert ready == [3]
    names = {e["name"] for e in _trace_events(str(tmp_path / "out"))
             if e.get("cat") == "user_annotation"}
    assert names == {"step1", "step2"}


# -------------------------------------------------------------- reader

@BOTH
def test_reader_decorators(m):
    reader = m.reader
    r = lambda: iter(range(10))             # noqa: E731
    assert list(reader.firstn(r, 3)()) == [0, 1, 2]
    assert sorted(reader.shuffle(r, 4)()) == list(range(10))
    assert list(reader.map_readers(lambda a, b: a + b, r, r)())[:3] \
        == [0, 2, 4]
    assert len(list(reader.buffered(r, 2)())) == 10
    assert list(reader.chain(r, r)()) == list(range(10)) * 2
    assert list(reader.cache(r)()) == list(range(10))
    assert list(reader.compose(r, r)())[:2] == [(0, 0), (1, 1)]
    assert list(reader.xmap_readers(lambda v: v * 3, r, 2, 4)()) == \
        [v * 3 for v in range(10)]


def test_shuffle_order_is_the_references():
    orders = []
    for m in (jt, pt):
        random.seed(7)
        orders.append(list(m.reader.shuffle(lambda: iter(range(50)), 16)()))
    assert orders[0] == orders[1] != list(range(50))


@BOTH
def test_buffered_surfaces_reader_errors(m):
    def bad():
        yield 1
        raise IOError("boom")

    with pytest.raises(IOError):
        list(m.reader.buffered(bad, 2)())


@BOTH
def test_compose_alignment_check(m):
    with pytest.raises(m.reader.ComposeNotAligned):
        list(m.reader.compose(lambda: iter(range(3)),
                              lambda: iter(range(5)))())


# ----------------------------------------------------------- cost_model

def _small_program(m):
    main = m.static.Program()
    with m.static.program_guard(main):
        x = m.static.data("x", [2, 3])
        _ = x * 2.0
    return main


def _mixed_program(m):
    static = m.static
    main = static.Program()
    with static.program_guard(main):
        w = static.create_parameter([512, 512], name="w_mm")
        x = static.data("x", [64, 512])
        y = x @ w                      # 2*64*512*512 matmul flops
        tbl = static.create_parameter([1000, 64], name="tbl")
        ids = static.data("ids", [256], dtype="int64")
        e = m.nn.functional.embedding(ids, tbl)
        z = y.sum() + e.sum()
    static.normalize_program(main, [x, ids], [z])
    return main


def test_profile_measure_is_the_references(on_cpu):
    want = jt.cost_model.CostModel().profile_measure(_small_program(jt))
    got = pt.cost_model.CostModel().profile_measure(_small_program(pt))
    assert got and got == want


def test_cost_model_separates_matmul_and_lookup(on_cpu):
    want = jt.cost_model.CostModel().measure_program(_mixed_program(jt))
    got = pt.cost_model.CostModel().measure_program(_mixed_program(pt))
    assert got["matmul_flops"] >= 2 * 64 * 512 * 512
    assert got["lookup_bytes"] > 0
    assert 0 < got["matmul_frac"] <= 1
    assert got == pytest.approx(want, rel=1e-12)


def test_xla_cost_analysis_counts_a_matmuls_flops_as_xla():
    M, K, N = 32, 64, 16
    a = np.ones((M, K), np.float32)
    b = np.ones((K, N), np.float32)
    want = jt.cost_model.xla_cost_analysis(lambda x, y: x @ y,
                                           jnp.asarray(a), jnp.asarray(b))
    got = pt.cost_model.xla_cost_analysis(lambda x, y: x @ y,
                                          torch.from_numpy(a),
                                          torch.from_numpy(b))
    assert got["flops"] == want["flops"] == 2 * M * N * K
    assert got["bytes accessed"] == want["bytes accessed"] == \
        4 * (M * K + K * N + M * N)
    meta = pt.cost_model.xla_cost_analysis(
        torch.matmul, torch.empty((M, K), device="meta"),
        torch.empty((K, N), device="meta"))
    assert meta["flops"] == 2 * M * N * K

"""The port's ``BatchScheduler`` against the JAX package's, on the CPU.

Counterparts of the scheduler tests of ``tests/test_static_inference.py``
(grouping, shape separation, runner errors, a scheduler over a real
``Predictor``), ``tests/test_serving_reliability.py`` (the wedged-runner
``close()``, ``max_queue``, deadlines, a submit after ``close()``) and
``tests/test_telemetry.py`` (the ``scheduler_*`` metrics), on the port's
scheduler; and a scripted test: both packages' schedulers fed the same
submits under a ``FakeClock`` (the runner held on a plug batch while the
script queues, so the groups depend on the queue alone) give the same
batches, the same results and errors, and the same ``/metrics`` page.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.telemetry as JT
import paddle_tpu_torch.telemetry as TT
from paddle_tpu.inference.serving import BatchScheduler as JaxScheduler
from paddle_tpu_torch import inference
from paddle_tpu_torch.inference import BatchScheduler
from paddle_tpu_torch.reliability import (DeadlineExceeded, QueueFullError,
                                          SchedulerClosed)
from paddle_tpu_torch.static import InputSpec

# (scheduler, telemetry) of each package, for the scripted comparison
SCHEDULERS = {"jax": (JaxScheduler, JT), "torch": (BatchScheduler, TT)}


def test_groups_requests_into_one_run():
    calls = []

    def runner(stacked):
        calls.append(stacked[0].shape[0])
        return [stacked[0] * 2.0, stacked[0].sum(-1, keepdims=True)]

    sched = BatchScheduler(runner, max_batch_size=8, max_delay_ms=60)
    xs = [np.full((1, 4), float(i), np.float32) for i in range(10)]
    futs = [sched.submit(x) for x in xs]
    outs = [f.result(timeout=20) for f in futs]
    sched.close()
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o[0], xs[i] * 2.0)
        np.testing.assert_allclose(o[1], xs[i].sum(-1, keepdims=True))
    assert sched.batches_run < 10, calls
    assert sum(calls) == 10


def test_mismatched_shapes_batch_separately():
    shapes = []

    def runner(stacked):
        shapes.append(stacked[0].shape)
        return [stacked[0] + 1.0]

    sched = BatchScheduler(runner, max_batch_size=8, max_delay_ms=30)
    f1 = sched.submit(np.zeros((1, 3), np.float32))
    f2 = sched.submit(np.zeros((1, 5), np.float32))
    r1, r2 = f1.result(timeout=20)[0], f2.result(timeout=20)[0]
    sched.close()
    assert r1.shape == (1, 3) and r2.shape == (1, 5)
    assert len(shapes) == 2, "different shapes must not mix"


def test_runner_error_propagates():
    def runner(stacked):
        raise RuntimeError("boom")

    sched = BatchScheduler(runner, max_batch_size=4, max_delay_ms=5)
    f = sched.submit(np.zeros((1, 2), np.float32))
    with pytest.raises(RuntimeError, match="boom"):
        f.result(timeout=20)
    sched.close()


def test_close_fails_pending_on_wedged_runner():
    release = threading.Event()

    def runner(arrs):
        release.wait(30)
        return [arrs[0]]

    sched = BatchScheduler(runner, max_batch_size=1, max_delay_ms=1.0)
    f1 = sched.submit(np.ones((1, 2), np.float32))
    time.sleep(0.15)                   # the worker is inside the runner
    f2 = sched.submit(np.ones((1, 2), np.float32))
    with pytest.raises(TimeoutError, match="did not exit"):
        sched.close(timeout=0.3)
    assert isinstance(f1.exception(timeout=5), SchedulerClosed)
    assert isinstance(f2.exception(timeout=5), SchedulerClosed)
    release.set()                      # unwedge; the late result is lost


def test_queue_bound_and_deadline():
    release = threading.Event()

    def runner(arrs):
        release.wait(30)
        return [arrs[0]]

    sched = BatchScheduler(runner, max_batch_size=1, max_delay_ms=1.0,
                           max_queue=1)
    f1 = sched.submit(np.ones((1, 2), np.float32))
    time.sleep(0.15)                   # f1 in flight, the queue empty
    f2 = sched.submit(np.ones((1, 2), np.float32))
    with pytest.raises(QueueFullError, match="max_queue"):
        sched.submit(np.ones((1, 2), np.float32))
    release.set()
    time.sleep(0.05)
    f3 = sched.submit(np.ones((1, 2), np.float32), deadline_s=0.0)
    assert isinstance(f3.exception(timeout=5), DeadlineExceeded)
    assert f1.result(timeout=5) is not None
    assert f2.result(timeout=5) is not None
    sched.close()


def test_submit_after_close_typed():
    sched = BatchScheduler(lambda s: [s[0]], max_batch_size=2)
    sched.close()
    with pytest.raises(SchedulerClosed, match="closed"):
        sched.submit(np.ones((1, 2), np.float32))


def test_metrics_publish_and_count_failures():
    reg = TT.MetricRegistry()
    sched = BatchScheduler(lambda xs: [xs[0] * 2.0], max_batch_size=8,
                           max_delay_ms=5, registry=reg)
    for f in [sched.submit(np.ones((2, 3), np.float32)) for _ in range(3)]:
        f.result(timeout=20)
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):   # not counted
        sched.submit(np.ones((1, 2), np.float32))
    assert reg.get("scheduler_requests_total").value == 3.0
    assert reg.get("scheduler_batches_total").value >= 1.0
    assert reg.get("scheduler_batch_rows").sum == 6.0
    assert reg.get("scheduler_queue_wait_seconds").count == 3
    reg = TT.MetricRegistry()
    sched = BatchScheduler(lambda xs: 1 / 0, max_delay_ms=1, registry=reg)
    with pytest.raises(ZeroDivisionError):
        sched.submit(np.ones((1, 2), np.float32)).result(timeout=20)
    sched.close()
    assert reg.get("scheduler_failures_total").value == 1.0


# rows, width, dtype and deadline (s) of each scripted submit
SCRIPT = [(1, 3, np.float32, None), (2, 3, np.float32, 1.0),
          (1, 5, np.float32, None), (3, 3, np.float32, None),
          (1, 3, np.int32, None), (2, 3, np.float32, 100.0),
          (1, 5, np.float32, 2.0), (5, 3, np.float32, None),
          (1, 3, np.float32, None), (2, 5, np.float32, None)]


def _scripted(side):
    """Queue ``SCRIPT`` behind a plug batch on a fake clock, advance it 5 s
    (expiring the deadlines of 1 s and 2 s), release the runner and
    drain. Returns (batches' shapes, each request's result or error
    type name, the registry's page)."""
    Sched, T = SCHEDULERS[side]
    clock, reg = T.FakeClock(), T.MetricRegistry()
    entered, release = threading.Event(), threading.Event()
    batches = []

    def runner(stacked):
        if not entered.is_set():
            entered.set()
            release.wait(20)
        batches.append([(a.shape, str(a.dtype)) for a in stacked])
        return [stacked[0] * 2 + 1, stacked[0].sum(-1, keepdims=True)]

    sched = Sched(runner, max_batch_size=4, max_delay_ms=10_000,
                  registry=reg, clock=clock)
    plug = sched.submit(np.zeros((4, 3), np.float32))   # fills a batch
    assert entered.wait(20)
    rng = np.random.default_rng(0)
    futs = [sched.submit(rng.integers(0, 9, (n, w)).astype(dt),
                         deadline_s=d) for n, w, dt, d in SCRIPT]
    clock.advance(5.0)
    release.set()
    sched.close(timeout=20)
    plug.result(timeout=5)
    results = []
    for f in futs:
        err = f.exception(timeout=5)
        results.append(type(err).__name__ if err is not None
                       else f.result())
    return batches, results, reg.render()


def test_scripted_submits_give_the_jax_schedulers_batches_and_results():
    jb, jr, jpage = _scripted("jax")
    tb, tr, tpage = _scripted("torch")
    assert tb == jb
    assert len(tr) == len(jr)
    for t, j in zip(tr, jr):
        if isinstance(j, str):
            assert t == j
        else:
            assert len(t) == len(j)
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    assert tpage == jpage
    assert [r for r in tr if isinstance(r, str)] == ["DeadlineExceeded"] * 2


def test_scheduler_over_a_port_predictor(tmp_path):
    """The scheduler over a ``Predictor`` of an exported layer (a dynamic
    batch), against the JAX package's over its own archive of the same
    weights: every request's slice within 1e-6 of the layer's own
    output and of the reference's."""
    from paddle_tpu import inference as jinf
    from paddle_tpu.static import InputSpec as JaxInputSpec
    pt.seed(3)
    jl = pt.nn.Linear(4, 3)
    tl = torch.nn.Linear(4, 3)
    with torch.no_grad():
        tl.weight.copy_(torch.tensor(np.asarray(jl.weight.numpy()).T))
        tl.bias.copy_(torch.tensor(np.asarray(jl.bias.numpy())))
    pt.jit.save(jl, str(tmp_path / "j"),
                input_spec=[JaxInputSpec([-1, 4], "float32", "x")])
    inference.export_layer(str(tmp_path / "t"), tl,
                           [InputSpec([-1, 4], "float32", "x")])
    cfg = inference.Config(str(tmp_path / "t"))
    cfg.disable_gpu()
    scheds = [
        BatchScheduler(inference.create_predictor(cfg), max_batch_size=4,
                       max_delay_ms=40),
        JaxScheduler(jinf.create_predictor(jinf.Config(str(tmp_path / "j"))),
                     max_batch_size=4, max_delay_ms=40)]
    xs = [np.full((1, 4), float(i), np.float32) for i in range(6)]
    outs = [[f.result(timeout=60) for f in [s.submit(x) for x in xs]]
            for s in scheds]
    for s in scheds:
        s.close()
    for x, t, j in zip(xs, *outs):
        with torch.no_grad():
            want = tl(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(t[0], want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t[0], np.asarray(j[0]), rtol=0,
                                   atol=1e-6)

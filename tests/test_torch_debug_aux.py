"""``tests/test_debug_aux.py`` on the port, held to the JAX package.

- the NaN/Inf sanitizer switched by the port's ``runtime.set_flags``
  (``FLAGS_check_nan_inf`` and its level, its live hook into
  ``set_nan_inf_check``): raise, warn, off by default, the grad path;
- ``incubate.softmax_mask_fuse`` and ``softmax_mask_fuse_upper_triangle``
  against the reference's, values and gradients within
  1e-6;
- ``incubate.checkpoint.TrainEpochRange``: the interrupted run and its
  resume give the reference's epochs, and the resumed model holds the
  snapshot's weights;
- ``utils.run_check`` on ``set_device("cpu")`` and ``device.memory_stats``
  there: ``{}``, as the reference's CPU device gives.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice

BOTH = pytest.mark.parametrize("m", [jt, pt], ids=["jax", "port"])


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


class TestNanInfCheck:
    def teardown_method(self):
        pt.runtime.set_flags({"FLAGS_check_nan_inf": 0,
                              "FLAGS_check_nan_inf_level": 0})

    def test_raises_on_nan(self):
        pt.runtime.set_flags({"FLAGS_check_nan_inf": 1})
        x = pt.to_tensor(np.array([1.0, 0.0], np.float32))
        with pytest.raises(FloatingPointError, match="Inf/Nan"):
            pt.log(x - 1.0)  # log(-1) and log(0)

    def test_warn_level(self):
        pt.set_flags({"FLAGS_check_nan_inf": 1,
                      "FLAGS_check_nan_inf_level": 1})
        x = pt.to_tensor(np.array([-1.0], np.float32))
        with pytest.warns(UserWarning, match="Inf/Nan"):
            pt.sqrt(x)

    def test_off_by_default(self):
        pt.runtime.set_flags({"FLAGS_check_nan_inf": 0})
        x = pt.to_tensor(np.array([-1.0], np.float32))
        out = pt.sqrt(x)  # silently nan, like the reference default
        assert np.isnan(out.numpy()).all()

    def test_checks_grad_path_outputs(self):
        pt.runtime.set_flags({"FLAGS_check_nan_inf": 1,
                              "FLAGS_check_nan_inf_level": 0})
        x = pt.to_tensor(np.array([0.0], np.float32), stop_gradient=False)
        with pytest.raises(FloatingPointError):
            pt.ops.OPS["divide"](pt.to_tensor(np.float32(1.0)), x)


def _softmax_case(m, fn, x, mask=None):
    xt = m.to_tensor(x, stop_gradient=False)
    args = (xt,) if mask is None else (xt, m.to_tensor(mask))
    out = getattr(m.incubate, fn)(*args)
    w = np.arange(out.size, dtype=np.float32).reshape(out.shape) / out.size
    (out * m.to_tensor(w)).sum().backward()
    return np.asarray(out.numpy()), np.asarray(xt.grad.numpy())


class TestFusedSoftmaxMask:
    def test_softmax_mask_fuse(self):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 2, 4, 4).astype(np.float32)
        mask = np.where(rng.rand(2, 1, 4, 4) < 0.3, -10000.0,
                        0.0).astype(np.float32)
        got = _softmax_case(pt, "softmax_mask_fuse", x, mask)
        want = _softmax_case(jt, "softmax_mask_fuse", x, mask)
        e = np.exp((x + mask) - (x + mask).max(-1, keepdims=True))
        np.testing.assert_allclose(got[0], e / e.sum(-1, keepdims=True),
                                   rtol=1e-5, atol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)

    def test_softmax_mask_fuse_upper_triangle(self):
        x = np.random.RandomState(0).randn(1, 2, 5, 5).astype(np.float32)
        got = _softmax_case(pt, "softmax_mask_fuse_upper_triangle", x)
        want = _softmax_case(jt, "softmax_mask_fuse_upper_triangle", x)
        for i in range(5):
            row = got[0][0, 0, i]
            assert np.allclose(row[i + 1:], 0)
            np.testing.assert_allclose(row[:i + 1].sum(), 1.0, rtol=1e-5)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)

    def test_upper_triangle_grad_flows(self):
        x = pt.to_tensor(np.random.randn(1, 1, 3, 3).astype(np.float32),
                         stop_gradient=False)
        out = pt.incubate.softmax_mask_fuse_upper_triangle(x)
        pt.ops.OPS["sum"](out).backward()
        assert x.grad is not None


def _resume_script(m, d):
    from importlib import import_module
    TrainEpochRange = import_module(
        f"{m.__name__}.incubate.checkpoint").TrainEpochRange
    m.seed(3)
    model = m.nn.Linear(4, 4)
    opt = m.optimizer.AdamW(parameters=model.parameters())
    r1 = TrainEpochRange(5, "job", checkpoint_dir=d)
    r1.add("model", model).add("opt", opt)
    seen = []
    for epoch in r1:
        seen.append(epoch)
        if epoch == 2:
            break  # preempted after e1's save: e2 is not saved
    model2 = m.nn.Linear(4, 4)
    opt2 = m.optimizer.AdamW(parameters=model2.parameters())
    r2 = TrainEpochRange(5, "job", checkpoint_dir=d)
    r2.add("model", model2).add("opt", opt2)
    return (seen, r2.restored_from(), list(r2),
            np.asarray(model.weight.numpy()),
            np.asarray(model2.weight.numpy()))


class TestAutoCheckpoint:
    def test_resume_after_interrupt(self, tmp_path):
        got = _resume_script(pt, str(tmp_path / "port"))
        want = _resume_script(jt, str(tmp_path / "jax"))
        assert got[:3] == want[:3] == ([0, 1, 2], 1, [2, 3, 4])
        # the resumed model holds the snapshot (the original's weights)
        np.testing.assert_array_equal(got[4], got[3])
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-7)


def test_run_check_and_memory_stats(capsys):
    pt.utils.run_check()
    assert "installed successfully" in capsys.readouterr().out
    assert pt.device.memory_stats() == {} == jt.device.memory_stats()
    assert pt.device.cuda.max_memory_allocated() == 0

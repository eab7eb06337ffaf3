"""The port's ``TrainSupervisor``, ``ResumableLoader``, supervised
``Model.fit`` and ``CallbackList``: the cases of the JAX package's
``tests/test_train_reliability.py`` (``TestResumableLoader``,
``TestSupervisorLoop``, ``TestSupervisedFit``,
``TestCallbackListFiresAll``) run on the port, on the CPU, merged into
parametrised cases where they repeat each other. Where the reference
reads its telemetry registry, the supervisor's own counters are read
(the registry's counters are held in ``tests/test_torch_hapi.py``); ``pt.rand`` becomes a draw
of ``core.random.next_key``. The fit cases train a 4-8-1 MLP (port
``nn.Linear`` layers in a ``torch.nn.Sequential``, ``Adam``,
``BCEWithLogitsLoss``); resumed runs must match uninterrupted ones BIT
FOR BIT."""
import os
import signal
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.hapi.callbacks import Callback, CallbackList
from paddle_tpu_torch.io import IterableDataset, TensorDataset
from paddle_tpu_torch.reliability import (AnomalyPolicy, CallbackError,
                                          CircuitBreaker, FaultInjector,
                                          ResumableLoader, RetryPolicy,
                                          StepFailedError,
                                          TrainAnomalyError,
                                          TrainSupervisor, faults)
from paddle_tpu_torch.telemetry.clock import FakeClock


# ----------------------------------------------------- tiny pure model
def _data(n=10):
    return list(np.arange(n, dtype=np.float64))


def _loader(seed=5, batch_size=3, shuffle=True):
    return ResumableLoader(_data(), batch_size=batch_size, shuffle=shuffle,
                           seed=seed)


def _step(s, b):
    m = float(np.mean(b))
    return s * 0.9 + 0.01 * m, s * 0.95 + 0.01 * m


def _zero_retry(**kw):
    return RetryPolicy(base_delay_s=0.0, jitter=0.0, **kw)


class TestResumableLoader:
    def test_order_is_pure_and_cursor_resume_exact(self):
        a, b = _loader(), _loader()
        for _ in range(9):                 # crosses an epoch boundary
            np.testing.assert_array_equal(a.next_batch(), b.next_batch())
        sd = a.state_dict()
        rest_a = [a.next_batch() for _ in range(5)]
        c = _loader()
        c.set_state_dict(sd)
        for x in rest_a:
            np.testing.assert_array_equal(x, c.next_batch())

    def test_drop_last_wrap_and_epochs_differ(self):
        dl = ResumableLoader(_data(10), batch_size=4, drop_last=True)
        assert len(dl) == 2
        assert [len(dl.next_batch()) for _ in range(5)] == [4] * 5
        assert dl.epoch >= 2
        dl = _loader(batch_size=10)
        assert not np.array_equal(dl.next_batch(), dl.next_batch())

    def test_set_state_dict_adopts_saved_seed(self):
        a = _loader(seed=7)
        for _ in range(2):
            a.next_batch()
        b = _loader(seed=0)
        b.set_state_dict(a.state_dict())
        assert b.seed == 7
        for _ in range(4):
            np.testing.assert_array_equal(a.next_batch(), b.next_batch())

    def test_drop_last_smaller_than_batch_refused(self):
        with pytest.raises(ValueError, match="drop_last"):
            ResumableLoader(_data(3), batch_size=8, drop_last=True)


class TestSupervisorLoop:
    @pytest.mark.parametrize("async_save", [False, True])
    def test_exact_resume_bit_matches_uninterrupted(self, tmp_path,
                                                    async_save):
        full = TrainSupervisor(str(tmp_path / "a"), save_interval_steps=4) \
            .run(_step, 1.0, _loader(), max_steps=11).losses
        d = str(tmp_path / "b")
        r1 = TrainSupervisor(d, save_interval_steps=4,
                             async_save=async_save).run(
            _step, 1.0, _loader(), max_steps=5)
        r2 = TrainSupervisor(d, save_interval_steps=4,
                             async_save=async_save).run(
            _step, 1.0, _loader(), max_steps=11)
        assert r2.resumed_from == 5
        assert r1.losses + r2.losses == full

    def test_transient_faults_retried_without_perturbing_losses(
            self, tmp_path):
        full = TrainSupervisor(str(tmp_path / "a"), save_interval_steps=4) \
            .run(_step, 1.0, _loader(), max_steps=11).losses
        fi = (FaultInjector(seed=3)
              .on(faults.TRAIN_STEP, probability=0.3)
              .on(faults.DATA_NEXT, probability=0.2))
        sup = TrainSupervisor(str(tmp_path / "b"), save_interval_steps=4,
                              injector=fi, retry=_zero_retry(),
                              max_step_retries=50)
        rep = sup.run(_step, 1.0, _loader(), max_steps=11)
        assert rep.retries > 0 and rep.retries == fi.fired()
        assert rep.losses == full

    @pytest.mark.parametrize("breaker,match", [
        (None, "attempts"),
        (lambda: CircuitBreaker(failure_threshold=4, clock=FakeClock()),
         "breaker")])
    def test_retry_exhaustion_is_typed(self, tmp_path, breaker, match):
        fi = FaultInjector(seed=0).on(faults.TRAIN_STEP, probability=1.0)
        sup = TrainSupervisor(str(tmp_path), injector=fi,
                              retry=_zero_retry(), max_step_retries=3
                              if breaker is None else 100,
                              breaker=breaker and breaker())
        with pytest.raises(StepFailedError, match=match):
            sup.run(_step, 1.0, _loader(), max_steps=2)

    def test_open_breaker_gates_then_probe_token_returns(self, tmp_path):
        clk = FakeClock()
        cb = CircuitBreaker(failure_threshold=1, reset_after_s=60,
                            clock=clk)
        cb.record_failure()
        sup = TrainSupervisor(str(tmp_path), breaker=cb)
        with pytest.raises(StepFailedError, match="open"):
            sup.run_with_retries(lambda: 1, faults.TRAIN_STEP)
        clk.advance(61)

        def exhausted():
            raise StopIteration

        with pytest.raises(StopIteration):
            sup.run_with_retries(exhausted, faults.DATA_NEXT)
        assert cb.state == cb.HALF_OPEN           # token handed back
        assert sup.run_with_retries(lambda: 1, faults.TRAIN_STEP) == 1
        assert cb.state == cb.CLOSED

    def test_anomaly_skip_then_rollback_then_recover(self, tmp_path):
        calls = {"n": 0}

        def poison(s, b):
            calls["n"] += 1
            if 6 <= calls["n"] <= 8:       # one burst of 3 NaN steps
                return float("nan"), s
            return _step(s, b)

        sup = TrainSupervisor(
            str(tmp_path), save_interval_steps=2,
            anomaly=AnomalyPolicy(max_consecutive=3, max_rollbacks=1))
        rep = sup.run(poison, 1.0, _loader(), max_steps=8)
        assert rep.status == "completed"
        assert rep.anomalies == 3 and rep.rollbacks == 1
        assert sup.anomalies == 3 and sup.rollbacks == 1

    @pytest.mark.parametrize("interval,policy,match", [
        (1, (2, 1), "nothing to roll"), (100, (1, 5), "nothing to roll")])
    def test_persistent_anomaly_aborts_typed(self, tmp_path, interval,
                                             policy, match):
        sup = TrainSupervisor(
            str(tmp_path), save_interval_steps=interval,
            anomaly=AnomalyPolicy(max_consecutive=policy[0],
                                  max_rollbacks=policy[1]))
        with pytest.raises(TrainAnomalyError, match=match) as ei:
            sup.run(lambda s, b: (float("nan"), s), 1.0, _loader(),
                    max_steps=4)
        assert ei.value.kind == "nonfinite_loss"

    @pytest.mark.parametrize("same_supervisor", [False, True])
    def test_request_preemption_checkpoints_and_resumes(self, tmp_path,
                                                        same_supervisor):
        d = str(tmp_path)
        sup = TrainSupervisor(d, save_interval_steps=100)
        n = {"v": 0}

        def step(s, b):
            n["v"] += 1
            if n["v"] == 3:
                sup.request_preemption()
            return _step(s, b)

        rep = sup.run(step, 1.0, _loader(), max_steps=11)
        assert rep.status == "preempted" and rep.steps_done == 3
        assert sup.preempts_total == 1
        full = TrainSupervisor(str(tmp_path / "x"),
                               save_interval_steps=100).run(
            _step, 1.0, _loader(), max_steps=11).losses
        sup2 = sup if same_supervisor else \
            TrainSupervisor(d, save_interval_steps=100)
        rep2 = sup2.run(_step, 1.0, _loader(), max_steps=11)
        assert rep2.status == "completed" and rep2.resumed_from == 3
        assert rep.losses + rep2.losses == full

    def test_sigterm_routes_to_preemption(self, tmp_path):
        if threading.current_thread() is not threading.main_thread():
            pytest.skip("signal handlers need the main thread")
        sup = TrainSupervisor(str(tmp_path), save_interval_steps=100)
        sup.install_signal_handlers()
        try:
            n = {"v": 0}

            def step(s, b):
                n["v"] += 1
                if n["v"] == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return _step(s, b)

            rep = sup.run(step, 1.0, _loader(), max_steps=50)
        finally:
            sup.uninstall_signal_handlers()
        assert rep.status == "preempted" and rep.steps_done < 50
        assert sup.store.latest_valid_step() == rep.steps_done

    def test_finite_data_source_completes_with_durable_final(self,
                                                             tmp_path):
        class Finite:
            def __init__(self, n):
                self.n = n

            def next_batch(self):
                if self.n == 0:
                    raise StopIteration
                self.n -= 1
                return np.full(3, float(self.n))

        sup = TrainSupervisor(str(tmp_path), save_interval_steps=100)
        rep = sup.run(_step, 1.0, Finite(4), max_steps=50)
        assert rep.status == "completed" and rep.steps_done == 4
        assert sup.store.latest_valid_step() == 4

    def test_global_rng_state_round_trips(self, tmp_path):
        """The port's core.random stream continues across a kill exactly
        where it stopped; the key rides the meta as numpy uint32 [2]."""
        def rng_step(s, b):
            u = float(prng.key_numpy(trandom.next_key())[0]) / 2 ** 32
            return s + u, s + u

        def run(d, k, fresh_seed):
            if fresh_seed:
                pt.seed(123)
            return TrainSupervisor(d, save_interval_steps=1).run(
                rng_step, 0.0, _loader(shuffle=False), max_steps=k)

        full = run(str(tmp_path / "a"), 6, True).losses
        run(str(tmp_path / "b"), 3, True)
        pt.seed(999)
        rep = run(str(tmp_path / "b"), 6, False)
        assert full[3:] == rep.losses
        _, meta, _ = TrainSupervisor(str(tmp_path / "b")).restore_state()
        assert meta["rng_key"].dtype == torch.uint32
        assert tuple(meta["rng_key"].shape) == (2,)

    def test_restore_state_can_leave_global_rng_alone(self, tmp_path):
        sup = TrainSupervisor(str(tmp_path), save_interval_steps=1)
        pt.seed(41)
        sup.save_state(1, {"w": 1.0}, force=True)
        trandom.next_key()
        moved = trandom.get_rng_state()
        _, meta, done = sup.restore_state(restore_rng=False)
        assert done == 1 and trandom.get_rng_state()[1] == moved[1]
        sup.restore_state()
        assert trandom.get_rng_state()[1] != moved[1]


class _Rec:
    def __init__(self, hook=None):
        self.losses = []
        self.hook = hook

    def set_model(self, m):
        pass

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])
        if self.hook:
            self.hook(len(self.losses))


def _model(learning_rate=0.01):
    pt.seed(7)          # the layers draw their weights from pt's stream
    torch.manual_seed(7)
    net = torch.nn.Sequential(nn.Linear(4, 8, device="cpu"),
                              torch.nn.ReLU(),
                              nn.Linear(8, 1, device="cpu"))
    m = pt.Model(net)
    m.prepare(optimizer=optimizer.Adam(
        learning_rate=learning_rate, parameters=net.parameters()),
        loss=nn.BCEWithLogitsLoss())
    return m


def _dataset(n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = (x.sum(-1, keepdims=True) > 0).astype(np.float32)
    return x, y


def _fit(m, ds, tmp, rec, epochs=2, interval=4, **kw):
    sup = kw.pop("supervisor", None) or TrainSupervisor(
        str(tmp), save_interval_steps=interval)
    m.fit(ds, batch_size=8, epochs=epochs, verbose=0, callbacks=[rec],
          supervisor=sup, **kw)
    return sup


class TestSupervisedFit:
    @pytest.mark.parametrize("workers", [0, 2])
    @pytest.mark.parametrize("same_model", [False, True])
    def test_fit_preempt_resume_bit_matches(self, tmp_path, workers,
                                            same_model):
        ds = TensorDataset(list(_dataset()))
        rec_full = _Rec()
        full = _model()
        _fit(full, ds, tmp_path / "a", rec_full, num_workers=workers)
        assert len(rec_full.losses) == 12
        sup = TrainSupervisor(str(tmp_path / "b"), save_interval_steps=4)
        rec1 = _Rec(hook=lambda n: n == 5 and sup.request_preemption())
        m = _model()
        _fit(m, ds, None, rec1, supervisor=sup, num_workers=workers)
        assert len(rec1.losses) == 5 and m.stop_training
        rec2 = _Rec()
        m2 = m if same_model else _model()
        _fit(m2, ds, None, rec2, num_workers=workers,
             supervisor=sup if same_model else TrainSupervisor(
                 str(tmp_path / "b"), save_interval_steps=4))
        assert rec1.losses + rec2.losses == rec_full.losses
        for a, b in zip(full.parameters(), m2.parameters()):
            assert torch.equal(a, b)

    def test_fit_lr_schedule_live_and_resume_bit_matches(self, tmp_path):
        def sched_model():
            return _model(optimizer.lr.StepDecay(0.05, step_size=1,
                                                    gamma=0.5))

        ds = TensorDataset(list(_dataset()))
        rec_full, m_full = _Rec(), sched_model()
        _fit(m_full, ds, tmp_path / "a", rec_full, epochs=3)
        assert len(rec_full.losses) == 18
        rec_const = _Rec()
        _fit(_model(0.05), ds, tmp_path / "c", rec_const)
        assert rec_const.losses[:6] == rec_full.losses[:6]
        assert rec_const.losses[6:12] != rec_full.losses[6:12]
        sup = TrainSupervisor(str(tmp_path / "b"), save_interval_steps=4)
        rec1 = _Rec(hook=lambda n: n == 8 and sup.request_preemption())
        _fit(sched_model(), ds, None, rec1, epochs=3, supervisor=sup)
        assert len(rec1.losses) == 8
        rec2, m2 = _Rec(), sched_model()
        _fit(m2, ds, tmp_path / "b", rec2, epochs=3)
        assert rec1.losses + rec2.losses == rec_full.losses
        assert m2._optimizer.get_lr() == m_full._optimizer.get_lr()

    def test_fit_resume_across_epoch_boundary(self, tmp_path):
        ds = TensorDataset(list(_dataset()))
        rec_full = _Rec()
        _fit(_model(), ds, tmp_path / "a", rec_full)
        _fit(_model(), ds, tmp_path / "b", _Rec(), epochs=1)
        rec2 = _Rec()
        _fit(_model(), ds, tmp_path / "b", rec2)
        assert rec2.losses == rec_full.losses[6:]

    def test_fit_num_iters_saves_mid_epoch_cursor_no_zombie_epochs(
            self, tmp_path):
        ds = TensorDataset(list(_dataset()))
        rec_full = _Rec()
        _fit(_model(), ds, tmp_path / "a", rec_full, epochs=1,
             interval=100)
        epochs_seen = []

        class EpochRec(_Rec):
            def on_epoch_begin(self, epoch, logs=None):
                epochs_seen.append(epoch)

        sup = _fit(_model(), ds, tmp_path / "b", EpochRec(), epochs=50,
                   interval=100, num_iters=2)
        assert epochs_seen == [0]
        _, meta, _ = sup.restore_state()
        assert meta["cursor"] == {"epoch": 0, "batch": 2}
        rec2 = _Rec()
        _fit(_model(), ds, tmp_path / "b", rec2, epochs=1, interval=100)
        assert rec2.losses == rec_full.losses[2:]

    def test_fit_iterable_dataset_refused(self, tmp_path):
        class Stream(IterableDataset):
            def __iter__(self):
                yield (np.zeros(4, np.float32), np.zeros(1, np.float32))

        with pytest.raises(ValueError, match="map-style"):
            _model().fit(Stream(), batch_size=8, verbose=0,
                         supervisor=TrainSupervisor(str(tmp_path)))

    def test_fit_rollback_before_any_checkpoint_aborts_typed(self,
                                                             tmp_path):
        x = np.full((16, 4), np.nan, np.float32)
        y = np.zeros((16, 1), np.float32)
        sup = TrainSupervisor(
            str(tmp_path), save_interval_steps=1000,
            anomaly=AnomalyPolicy(max_consecutive=1, max_rollbacks=2))
        with pytest.raises(TrainAnomalyError, match="nothing to roll"):
            _model().fit(TensorDataset([x, y]), batch_size=8, epochs=1,
                         verbose=0, supervisor=sup)

    def test_fit_real_data_error_propagates_loudly(self, tmp_path):
        class Bad:
            def __len__(self):
                return 24

            def __getitem__(self, i):
                if i == 13:
                    raise RuntimeError("disk hiccup")
                return np.zeros(4, np.float32), np.zeros(1, np.float32)

        with pytest.raises(RuntimeError, match="disk hiccup"):
            _model().fit(Bad(), batch_size=8, epochs=1, shuffle=False,
                         verbose=0, callbacks=[_Rec()],
                         supervisor=TrainSupervisor(str(tmp_path),
                                                    save_interval_steps=4))

    def test_fit_rollback_replays_same_batches_bit_exact(self, tmp_path):
        x, y = _dataset(seed=3)

        class Transient:
            healed = False

            def __len__(self):
                return 48

            def __getitem__(self, i):
                if not Transient.healed and i >= 32:
                    return x[i], np.full((1,), np.nan, np.float32)
                return x[i], y[i]

        clean = _Rec()
        _fit(_model(), TensorDataset([x, y]), tmp_path / "a", clean,
             epochs=1, interval=2, shuffle=False)
        assert len(clean.losses) == 6
        sup = TrainSupervisor(
            str(tmp_path / "b"), save_interval_steps=2,
            anomaly=AnomalyPolicy(max_consecutive=2, max_rollbacks=1))
        rec = _Rec(hook=lambda n: (sup.rollbacks
                                   and setattr(Transient, "healed", True)))
        _fit(_model(), Transient(), None, rec, epochs=1, shuffle=False,
             supervisor=sup)
        assert sup.rollbacks == 1 and sup.anomalies == 2
        assert [v for v in rec.losses if np.isfinite(v)] == clean.losses

    def test_fit_persistent_nan_replays_into_wall_and_aborts(self,
                                                             tmp_path):
        x, y = _dataset(24, seed=4)
        y[8:] = np.nan
        sup = TrainSupervisor(
            str(tmp_path), save_interval_steps=1,
            anomaly=AnomalyPolicy(max_consecutive=2, max_rollbacks=1))
        with pytest.raises(TrainAnomalyError):
            _model().fit(TensorDataset([x, y]), batch_size=8, epochs=2,
                         shuffle=False, verbose=0, supervisor=sup)
        assert sup.rollbacks == 1

    def test_guarded_step_rebuilds_when_check_grads_changes(self):
        m = _model()
        m._build_guarded_step(check_grads=True)
        first = m._gstep_fn
        m._build_guarded_step(check_grads=True)
        assert m._gstep_fn is first
        m._build_guarded_step(check_grads=False)
        assert m._gstep_fn is not first

    def test_fit_nan_step_skipped_params_unpoisoned(self, tmp_path):
        x, y = _dataset(24)
        y[8:16] = np.nan                    # batch 1 of 3 is poisoned
        sup = TrainSupervisor(str(tmp_path), save_interval_steps=100,
                              anomaly=AnomalyPolicy(max_consecutive=10))
        m = _model()
        _fit(m, TensorDataset([x, y]), None, _Rec(), shuffle=False,
             supervisor=sup)
        for v in m.network.state_dict().values():
            assert torch.isfinite(v).all()
        assert sup.anomalies == 2           # poisoned batch, both epochs
        assert m._step_count == 6


class TestCallbackListFiresAll:
    def test_all_callbacks_fire_then_first_error_raised(self):
        fired = []

        class Boom(Callback):
            def on_epoch_end(self, epoch, logs=None):
                fired.append("boom")
                raise ValueError("poisoned logger")

        class Quiet(Callback):
            def on_epoch_end(self, epoch, logs=None):
                fired.append("quiet")

        cbs = CallbackList([Boom(), Quiet(), Boom()])
        with pytest.raises(CallbackError) as ei:
            cbs.on_epoch_end(0, {})
        assert fired == ["boom", "quiet", "boom"]
        assert ei.value.rid == "Boom"
        assert isinstance(ei.value.__cause__, ValueError)
        assert len(ei.value.errors) == 2

    def test_clean_sweep_raises_nothing(self):
        cbs = CallbackList([Callback(), Callback()])
        cbs.on_epoch_end(0, {})
        cbs.on_train_end()

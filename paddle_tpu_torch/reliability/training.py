"""Supervised, fault-tolerant training: exact resume + anomaly policy.

Port of ``paddle_tpu/reliability/training.py`` (framework-free but for
the global RNG state, which is the port's ``core.random``: its key is
checkpointed as a numpy ``uint32 [2]``, as the reference's jax key is).
The telemetry counters wait for the port's telemetry: ``registry=``
raises ``NotImplementedError`` (ROADMAP Queue 1 item 8).

``TrainSupervisor`` is the training-side sibling of ``ServeSupervisor``:
it owns the durable ``CheckpointStore``, the retry/breaker policy around
each step, NaN/Inf anomaly accounting, and preemption (SIGTERM) →
checkpoint-and-clean-exit. It is used two ways:

- the standalone loop ``supervisor.run(step_fn, state, data, ...)`` for
  functional training loops (``step_fn(state, batch) -> (loss,
  new_state)`` must be PURE given state+batch — that purity is what
  makes retries free and resume bit-exact);
- as the policy brain ``hapi.Model.fit(supervisor=...)`` consults
  around every batch (see hapi/model.py).

Exact-resume contract: a checkpoint captures the state pytree, the
number of completed steps, the data cursor (``ResumableLoader.
state_dict`` — epoch + batch index with per-epoch seeded shuffles), and
(opt-in) the global ``core.random`` PRNG state. A run killed at any
instant and resumed from the last durable checkpoint replays the SAME
batches through the SAME step function from the SAME state — its
per-step losses bit-match the uninterrupted run.

Anomaly policy: a non-finite loss (or a guarded step reporting
non-finite grads) marks the step anomalous — the state update is
SKIPPED (the poisoned batch is consumed and passed over). After
``max_consecutive`` anomalies in a row the supervisor ROLLS BACK to the
last good checkpoint (state + cursor + RNG); after ``max_rollbacks``
rollbacks it aborts with the typed ``TrainAnomalyError`` — a wedged run
dies loudly, never silently diverges.
"""
import math
import threading

from . import faults as _faults
from .ckpt import AsyncCheckpointer, CheckpointStore
from .errors import StepFailedError, TrainAnomalyError
from .retry import RetryPolicy

__all__ = ["AnomalyPolicy", "TrainReport", "TrainSupervisor",
           "ResumableLoader"]

ANOMALY_NONFINITE_LOSS = "nonfinite_loss"
ANOMALY_NONFINITE_GRAD = "nonfinite_grad"


class AnomalyPolicy:
    """Knobs for NaN/Inf handling.

    - ``max_consecutive``: anomalous steps in a row tolerated (each is
      skipped) before a rollback to the last good checkpoint.
    - ``max_rollbacks``: rollbacks tolerated before the run aborts with
      ``TrainAnomalyError``.
    - ``check_grads``: guarded hapi steps also test gradient finiteness
      (a NaN grad with a finite loss still poisons the params).
    """

    def __init__(self, max_consecutive=3, max_rollbacks=2,
                 check_grads=True):
        if max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1")
        if max_rollbacks < 0:
            raise ValueError("max_rollbacks must be >= 0")
        self.max_consecutive = int(max_consecutive)
        self.max_rollbacks = int(max_rollbacks)
        self.check_grads = bool(check_grads)


class TrainReport:
    """What one supervised run did: ``status`` is ``"completed"`` |
    ``"preempted"``; ``losses`` is ``[(step, loss), ...]`` with exactly
    ONE entry per committed step (skipped/anomalous steps do not
    appear, and steps reverted by a rollback are dropped when they
    re-run); ``resumed_from`` is the checkpoint step count the run
    restored (None for a fresh start)."""

    def __init__(self):
        self.status = "completed"
        self.resumed_from = None
        self.steps_done = 0
        self.losses = []
        self.anomalies = 0
        self.rollbacks = 0
        self.retries = 0
        self.saved_steps = []
        self.final_state = None

    def __repr__(self):
        return (f"TrainReport(status={self.status!r}, "
                f"steps_done={self.steps_done}, "
                f"resumed_from={self.resumed_from}, "
                f"anomalies={self.anomalies}, "
                f"rollbacks={self.rollbacks}, retries={self.retries})")


class ResumableLoader:
    """Deterministic, cursor-tracked batch stream over an indexable
    dataset. Epoch ``e``'s order is a pure function of ``(seed, e)``
    (seeded permutation when ``shuffle``), so ``state_dict()`` — just
    ``{"epoch", "index"}`` — is enough to resume BIT-EXACTLY: no
    replaying of consumed batches, no dependence on global RNG.

    ``next_batch()`` is atomic: the cursor only advances after the
    batch is materialized, so a crash mid-fetch neither skips nor
    double-delivers data. The stream is infinite (epochs wrap); bound
    it with the supervisor's ``max_steps``.

    Deliberately SEPARATE from ``io.DataLoader`` +
    ``DistributedBatchSampler`` (hapi fit's resume path): this is a
    minimal stream with its own seed scheme, so a checkpoint cursor
    written by one path is not resumable by the other — pick one
    loader per run directory.
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0,
                 drop_last=False, collate_fn=None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if len(dataset) == 0:
            raise ValueError("dataset is empty")
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"drop_last with {len(dataset)} samples < batch_size "
                f"{batch_size} would yield no batches ever")
        from ..io.dataloader import default_collate_fn
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self.collate_fn = collate_fn or default_collate_fn
        self.epoch = 0
        self.index = 0                 # next batch index within epoch
        self._order = None             # cached permutation for .epoch
        self._order_epoch = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def _epoch_order(self):
        if self._order_epoch != self.epoch:
            import numpy as np
            n = len(self.dataset)
            if self.shuffle:
                rng = np.random.RandomState(
                    (self.seed * 1000003 + self.epoch) % (2 ** 32))
                self._order = rng.permutation(n)
            else:
                self._order = np.arange(n)
            self._order_epoch = self.epoch
        return self._order

    def next_batch(self):
        """The next collated batch; wraps epochs automatically."""
        while True:
            order = self._epoch_order()
            start = self.index * self.batch_size
            idxs = order[start:start + self.batch_size]
            if len(idxs) == 0 or (self.drop_last
                                  and len(idxs) < self.batch_size):
                self.epoch += 1
                self.index = 0
                continue
            batch = self.collate_fn([self.dataset[int(i)] for i in idxs])
            self.index += 1
            return batch

    def state_dict(self):
        return {"epoch": self.epoch, "index": self.index,
                "seed": self.seed}

    def set_state_dict(self, sd):
        self.epoch = int(sd["epoch"])
        self.index = int(sd["index"])
        if "seed" in sd:
            # adopt the run's original seed: a loader rebuilt with a
            # different one would silently replay DIFFERENT batches
            self.seed = int(sd["seed"])
        self._order = self._order_epoch = None


class TrainSupervisor:
    """Fault-tolerance policy + durable-checkpoint bookkeeping for one
    training run.

    >>> sup = TrainSupervisor("/ckpts/run1", save_interval_steps=50)
    >>> sup.install_signal_handlers()        # SIGTERM -> clean exit
    >>> report = sup.run(step_fn, state, loader, max_steps=10_000)

    ``store`` may be a directory path or a ``CheckpointStore``;
    ``async_save=True`` moves serialization+fsync off the step path
    (bounded in-flight, overlap barrier — see ``AsyncCheckpointer``).
    """

    def __init__(self, store, save_interval_steps=1, anomaly=None,
                 retry=None, breaker=None, max_step_retries=3,
                 async_save=False, track_global_rng=True,
                 injector=None, registry=None, max_to_keep=None):
        if registry is not None:
            raise NotImplementedError(
                "TrainSupervisor(registry=...): the telemetry registry is "
                "not ported yet (ROADMAP Queue 1 item 8)")
        if not isinstance(store, CheckpointStore):
            store = CheckpointStore(store, max_to_keep=max_to_keep,
                                    injector=injector)
        else:
            if injector is not None and store.injector is None:
                store.injector = injector
        self.store = store
        self.save_interval_steps = int(save_interval_steps)
        if self.save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        self.anomaly = anomaly if anomaly is not None else AnomalyPolicy()
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker
        self.max_step_retries = int(max_step_retries)
        self.track_global_rng = bool(track_global_rng)
        self.injector = injector
        self._async = (AsyncCheckpointer(self.store) if async_save
                       else None)
        self._preempt = threading.Event()
        self._old_handlers = []
        self._since_save = 0
        self._consec_anomalies = 0
        self.anomalies = 0
        self.rollbacks = 0
        self.retries_total = 0
        self.preempts_total = 0

    # ------------------------------------------------------- preemption
    @property
    def preempted(self):
        return self._preempt.is_set()

    def request_preemption(self):
        """Flag the run for checkpoint-and-clean-exit at the next step
        boundary (what the SIGTERM handler calls; safe from any
        thread/handler — it only sets an event)."""
        self._preempt.set()

    def clear_preemption(self):
        self._preempt.clear()

    def note_preempt(self):
        """Account one handled preemption; the loop acting on
        ``preempted`` calls this exactly once."""
        self.preempts_total += 1

    def install_signal_handlers(self, signals=None):
        """Route SIGTERM (by default) to ``request_preemption``. Main
        thread only (CPython restriction). Pair with
        ``uninstall_signal_handlers`` in long-lived processes/tests."""
        import signal as _signal
        for s in signals or (_signal.SIGTERM,):
            old = _signal.signal(s, lambda *_: self.request_preemption())
            self._old_handlers.append((s, old))

    def uninstall_signal_handlers(self):
        import signal as _signal
        while self._old_handlers:
            s, old = self._old_handlers.pop()
            _signal.signal(s, old)

    # ------------------------------------------------------ checkpoints
    def _rng_meta(self):
        if not self.track_global_rng:
            return {}
        from ..core import prng
        from ..core import random as _random
        key, count = _random.get_rng_state()
        return {"rng_key": prng.key_numpy(key), "rng_count": count}

    def _restore_rng(self, meta):
        if not self.track_global_rng or "rng_key" not in meta:
            return
        from ..core import random as _random
        _random.set_rng_state((meta["rng_key"], meta["rng_count"]))

    def save_state(self, step, state, meta=None, force=False):
        """Commit a checkpoint when ``save_interval_steps`` committed
        steps have accumulated (or ``force``). ``step`` is the number
        of COMPLETED steps. Returns True when a save was issued.
        ``meta`` may be a zero-arg callable — evaluated only when the
        save actually commits, so per-step callers don't pay meta
        construction for every skipped interval step."""
        self._since_save += 1
        if not force and self._since_save < self.save_interval_steps:
            return False
        self._since_save = 0
        if callable(meta):
            meta = meta()
        meta = dict(meta or {})
        meta["step"] = int(step)
        meta.update(self._rng_meta())
        if self._async is not None:
            self._async.save(step, state, meta)
        else:
            self.store.save(step, state, meta)
        return True

    def restore_state(self, restore_rng=True):
        """(state, meta, completed_steps) from the newest VALID
        checkpoint (corrupt ones are skipped), restoring the global RNG
        when tracked; ``(None, None, None)`` on an empty store.
        ``restore_rng=False`` leaves the global ``core.random`` stream
        untouched — for callers doing a model-state-only rollback that
        keeps moving FORWARD through data (rewinding the stream there
        would replay past subkeys into augmentation/callback
        randomness). Both the standalone ``run`` loop and
        ``hapi.Model.fit`` roll back the FULL cursor (state + data +
        RNG), so they use the default."""
        self.wait_for_saves()
        state, meta, found = self.store.restore()
        if found is None:
            return None, None, None
        if restore_rng:
            self._restore_rng(meta)
        return state, meta, int(meta.get("step", found))

    def wait_for_saves(self):
        if self._async is not None:
            self._async.wait()

    # ------------------------------------------------- step supervision
    def run_with_retries(self, fn, point, *args):
        """Run ``fn(*args)`` with the injector's ``point`` armed and the
        retry/backoff (and optional breaker) policy applied. Raises
        ``StepFailedError`` once the budget is exhausted or the breaker
        opens — transient chaos never kills a run early."""
        attempt = 0
        while True:
            if self.breaker is not None and not self.breaker.allow():
                raise StepFailedError(
                    f"circuit breaker open (cooling down) at {point}")
            try:
                if self.injector is not None:
                    self.injector.check(point)
                out = fn(*args)
            except StopIteration:       # exhausted data is not a fault
                if self.breaker is not None:
                    # no verdict either: a half-open probe token taken
                    # by allow() above must be returned, or end-of-data
                    # coinciding with a recovering breaker wedges it
                    # half-open (denying every later step) forever
                    self.breaker.release_probe()
                raise
            except Exception as e:
                opened = (self.breaker.record_failure()
                          if self.breaker is not None else False)
                if opened:
                    raise StepFailedError(
                        f"circuit breaker opened at {point}") from e
                if attempt >= self.max_step_retries:
                    raise StepFailedError(
                        f"{point} failed after {attempt + 1} attempts") \
                        from e
                self.retries_total += 1
                self.retry.sleep(attempt)
                attempt += 1
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            return out

    def note_ok(self):
        self._consec_anomalies = 0

    def note_anomaly(self, kind=ANOMALY_NONFINITE_LOSS, step=None):
        """Record an anomalous step. Returns ``"skip"`` (tolerate, do
        not commit the update) or ``"rollback"`` (restore the last good
        checkpoint); raises ``TrainAnomalyError`` once the rollback
        budget is spent."""
        self.anomalies += 1
        self._consec_anomalies += 1
        if self._consec_anomalies < self.anomaly.max_consecutive:
            return "skip"
        if self.rollbacks >= self.anomaly.max_rollbacks:
            raise TrainAnomalyError(
                f"{self._consec_anomalies} consecutive {kind} anomalies "
                f"persisted through {self.rollbacks} rollback(s)",
                kind=kind, step=step)
        self._consec_anomalies = 0
        self.rollbacks += 1
        return "rollback"

    # --------------------------------------------------- standalone loop
    def run(self, step_fn, state, data, max_steps, meta_fn=None,
            resume=True):
        """Supervised training loop. ``step_fn(state, batch) -> (loss,
        new_state)`` pure; ``data`` is a ``ResumableLoader`` (or any
        object with ``next_batch`` and optionally ``state_dict`` /
        ``set_state_dict``); ``max_steps`` bounds TOTAL completed steps
        across resumes. ``meta_fn(done, state)`` may contribute extra
        checkpoint metadata. Returns a ``TrainReport``."""
        report = TrainReport()
        retries_at_start = self.retries_total
        # a pending preemption belonged to the run it interrupted; this
        # invocation IS the resume
        self.clear_preemption()
        done = 0
        if resume:
            r_state, r_meta, r_step = self.restore_state()
            if r_step is not None:
                state, done = r_state, r_step
                report.resumed_from = r_step
                if hasattr(data, "set_state_dict") and "data" in r_meta:
                    data.set_state_dict(r_meta["data"])

        def ckpt_meta():
            meta = {}
            if hasattr(data, "state_dict"):
                meta["data"] = data.state_dict()
            if meta_fn is not None:
                meta.update(meta_fn(done, state) or {})
            return meta

        while done < max_steps:
            if self.preempted:
                self.note_preempt()
                self.save_state(done, state, ckpt_meta(), force=True)
                self.wait_for_saves()
                report.status = "preempted"
                report.retries = self.retries_total - retries_at_start
                report.final_state = state
                return report
            try:
                batch = self.run_with_retries(data.next_batch,
                                              _faults.DATA_NEXT)
            except StopIteration:
                break               # finite data source ran dry: wrap
                #                     up normally (durable final save)
            loss, new_state = self.run_with_retries(
                step_fn, _faults.TRAIN_STEP, state, batch)
            lf = float(loss)
            if not math.isfinite(lf):
                action = self.note_anomaly(ANOMALY_NONFINITE_LOSS,
                                           step=done)
                report.anomalies += 1
                if action == "rollback":
                    report.rollbacks += 1
                    r_state, r_meta, r_step = self.restore_state()
                    if r_step is None:
                        raise TrainAnomalyError(
                            "anomalies before any checkpoint existed: "
                            "nothing to roll back to",
                            kind=ANOMALY_NONFINITE_LOSS, step=done)
                    state, done = r_state, r_step
                    if hasattr(data, "set_state_dict") \
                            and "data" in r_meta:
                        data.set_state_dict(r_meta["data"])
                    # the reverted steps re-run: drop their entries so
                    # report.losses holds exactly ONE entry per
                    # committed step (the bit-match consumers' contract)
                    kept = [(s, l) for s, l in report.losses
                            if s < r_step]
                    report.steps_done -= len(report.losses) - len(kept)
                    report.losses = kept
                continue                    # skip: state not committed
            self.note_ok()
            state = new_state
            report.losses.append((done, lf))
            done += 1
            report.steps_done += 1
            if self.save_state(done, state, ckpt_meta):
                report.saved_steps.append(done)
        # make the final state durable so a follow-up run resumes here
        self.save_state(done, state, ckpt_meta(), force=True)
        self.wait_for_saves()
        report.status = "completed"
        report.retries = self.retries_total - retries_at_start
        report.final_state = state
        return report

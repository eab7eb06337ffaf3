"""paddle.Model — the Keras-like high-level API, on the card.

Port of ``paddle_tpu/hapi/model.py``. The reference jits one train step
over ``(params, opt_state, batch, step, rng, lr)`` and gets new
parameters and state back; here the step runs eagerly on the network's
own parameters (the card's kernels: K4, K5 and K6 in the Llama forward
and backward) and updates them, and the optimizer's state, IN PLACE
through the optimizer's functional facade (``Optimizer.functional()``:
for Adam and AdamW one ``multi_tensor_adam`` launch). What the
reference's step computes, this one computes:

- the update's step is the model's own count, which advances before
  every step, skipped ones included (``model.py:309``), never
  ``optimizer.step()``'s;
- no gradient clip, and ``weight_decay`` on every parameter
  (``optimizer.py:201-215``; ROADMAP Queue 3);
- the learning rate is read as ``float(optimizer.get_lr())`` at every
  step, and a scheduler steps once an epoch, after its batches;
- ``fit`` splits a key chain from ``PRNGKey(0)`` once a step and runs
  the forward inside ``rng_scope`` of the new subkey; ``train_batch``
  uses ``PRNGKey(step)``.

Gradients are cleared before every forward (torch keeps them; a retried
or skipped step must not add to a stale one). Under a supervisor the
guarded step decides from the loss and every gradient whether each is
finite, reads that flag once, and only then updates: a skipped step
leaves parameters and state bit for bit as they were. The checkpoint
state is the reference's ``{"params": {name: tensor}, "opt_state":
{state name: {name: tensor}}}``, so a run checkpointed by either
package resumes in the other. Each batch moves to the network's device
once a step; the loader's workers only ever see numpy.
"""
import functools

import numpy as np
import torch

from ..core import prng
from ..core.random import _as_key, rng_scope
from ..io.dataloader import (DataLoader, DistributedBatchSampler,
                             IterableDataset)
from ..io.save_load import load, save
from ..models.bridge import _host
from ..nn.layer import set_state_dict
from ..optimizer.lr import LRScheduler
from ..reliability import faults as _faults
from ..reliability import training as _rt
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model"]


def _all_finite(tensors):
    """One bool tensor on the tensors' device: every element of every
    tensor finite. Each tensor's largest magnitude, all in one
    multi-tensor pass: a NaN propagates, an Inf stays, a finite value
    cannot overflow."""
    return torch.stack(torch._foreach_norm(tensors, float("inf"))) \
        .isfinite().all()


@torch.no_grad()
def _copy_tree(dst, src, where):
    """Copy the tree ``src`` (tensors or arrays) into the tensors of
    ``dst``, which must have the same keys and shapes."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(
                f"checkpoint {where} differs from the model's: keys "
                f"{sorted(src) if isinstance(src, dict) else type(src)} "
                f"against {sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{where}.{k}")
        return
    t = torch.as_tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint {where}: shape {tuple(t.shape)} "
                         f"against the model's {tuple(dst.shape)}")
    dst.copy_(t.to(device=dst.device, dtype=dst.dtype))


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self._step_fn = None
        self._update_fn = None
        self._gstep_fn = None
        self._gstep_check_grads = None
        self._params = None
        self._opt_state = None
        self._step_count = 0
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics else [])
        return self

    # ------------------------------------------------------------- build
    def _device(self):
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _loss_of(self, inputs, labels, rng):
        """The loss of one batch: the forward inside ``rng_scope(rng)``
        (when given), then the loss layer — ONE definition for the fast
        and the guarded step."""
        if rng is None:
            out = self.network(*inputs)
        else:
            with rng_scope(rng):
                out = self.network(*inputs)
        return self._loss(out, *labels)

    def _build_steps(self):
        if self._step_fn is not None:
            return
        self._params = {n: p for n, p in self.network.named_parameters()
                        if p.requires_grad}
        if self._optimizer is not None:
            init_fn, self._update_fn = self._optimizer.functional()
            self._opt_state = init_fn(self._params)
        self._step_fn = self._train_step

    def _build_guarded_step(self, check_grads=True):
        """The anomaly-guarded step for supervised fit (``_guarded_step``
        with this policy), rebuilt when ``check_grads`` changes."""
        if self._gstep_fn is not None and \
                self._gstep_check_grads == check_grads:
            return
        self._gstep_check_grads = check_grads
        self._build_steps()
        self._gstep_fn = functools.partial(self._guarded_step,
                                           check_grads=check_grads)

    def _clear_grads(self):
        for p in self._params.values():
            p.grad = None

    def _loss_and_grads(self, inputs, labels, rng):
        """(detached loss, {name: gradient}); the gradients are cleared
        first. A parameter the loss does not reach gets zeros, as
        ``jax.value_and_grad`` gives it."""
        self._clear_grads()
        loss = self._loss_of(inputs, labels, rng)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self._params.items()}
        return loss.detach(), grads

    def _train_step(self, inputs, labels, step, rng, lr):
        loss, grads = self._loss_and_grads(inputs, labels, rng)
        self._update_fn(grads, self._params, self._opt_state, lr=lr,
                        step=step)
        self._clear_grads()
        return loss

    def _guarded_step(self, inputs, labels, step, rng, lr, check_grads):
        """The step, committed only when the loss and (with
        ``check_grads``) every gradient are finite: ``(loss,
        loss_finite, grads_finite)``. The flags are read from the card
        once, before the update; a refused step changes nothing."""
        loss, grads = self._loss_and_grads(inputs, labels, rng)
        flags = [torch.isfinite(loss)]
        if check_grads:
            flags.append(_all_finite(list(grads.values())))
        flags = torch.stack(flags).tolist()
        loss_fin, grad_fin = flags[0], flags[-1] if check_grads else True
        if loss_fin and grad_fin:
            self._update_fn(grads, self._params, self._opt_state, lr=lr,
                            step=step)
        self._clear_grads()
        return loss, loss_fin, grad_fin

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self._device())
        return torch.as_tensor(np.asarray(x), device=self._device())

    def _split(self, batch):
        if isinstance(batch, (list, tuple)):
            arrs = [self._to_device(b) for b in batch]
            if len(arrs) == 1:
                return tuple(arrs), ()
            return tuple(arrs[:-1]), (arrs[-1],)
        return (self._to_device(batch),), ()

    def _as_batch(self, xs):
        xs = xs if isinstance(xs, (list, tuple)) else \
            [xs] if xs is not None else []
        return tuple(self._to_device(x) for x in xs)

    # ------------------------------------------------------------- train
    def _ckpt_state(self):
        return {"params": self._params, "opt_state": self._opt_state}

    def _lr_sched(self):
        lr = getattr(self._optimizer, "_lr", None)
        return lr if isinstance(lr, LRScheduler) else None

    def _cur_lr(self):
        return float(self._optimizer.get_lr())

    def _fit_meta(self, epoch, batch, rng):
        meta = {"step_count": self._step_count,
                "cursor": {"epoch": epoch, "batch": batch},
                "fit_rng": prng.key_numpy(rng)}
        sched = self._lr_sched()
        if sched is not None:
            meta["lr"] = sched.state_dict()
        return meta

    def _apply_checkpoint(self, state, meta):
        """Load a supervisor checkpoint's model-side pieces (params,
        optimizer state, step count, LR schedule) into the model's own
        tensors — shared by fresh resume and anomaly rollback."""
        _copy_tree(self._params, state["params"], "params")
        _copy_tree(self._opt_state, state["opt_state"], "opt_state")
        self._step_count = int(meta.get("step_count",
                                        meta.get("step", 0)))
        sched = self._lr_sched()
        if sched is not None and "lr" in meta:
            sched.set_state_dict(meta["lr"])

    def _restore_fit(self, supervisor):
        """Load the newest valid checkpoint into the model; returns
        (rng, start_epoch, skip_batches) or None for a fresh start."""
        state, meta, done = supervisor.restore_state()
        if done is None:
            return None
        self._apply_checkpoint(state, meta)
        return self._fit_cursor(meta)

    @staticmethod
    def _fit_cursor(meta):
        """Decode a checkpoint's fit position — ``(rng, epoch, batch)``
        — the ONE meta-to-cursor mapping both kill+resume
        (``_restore_fit``) and in-process anomaly rollback
        (``_supervised_step``) restore through."""
        cursor = meta.get("cursor", {"epoch": 0, "batch": 0})
        rng = meta.get("fit_rng")
        rng = prng.PRNGKey(0) if rng is None else _as_key(rng)
        return rng, int(cursor["epoch"]), int(cursor["batch"])

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, supervisor=None):
        """Train. With ``supervisor`` (a ``reliability.TrainSupervisor``)
        the loop becomes fault-tolerant: durable periodic checkpoints
        (params, optimizer state, RNG, LR schedule, epoch/batch cursor),
        EXACT resume on re-invocation after a kill, NaN/Inf steps
        skipped in-step (guarded update) with rollback-to-last-good
        after K in a row — a rollback restores the DATA CURSOR and rng
        chain alongside model state, replaying the same batches from
        the same state — transient STEP failures retried with backoff
        (data-side retry covers INJECTED faults only: a real loader
        failure surfaces loudly), and SIGTERM / ``request_preemption``
        → checkpoint + clean early return. Exact resume additionally
        needs a deterministic batch order, so the self-built loader
        switches to a per-epoch-seeded sampler
        (``DistributedBatchSampler`` at nranks=1); pass
        ``shuffle=False`` or your own epoch-seeded loader otherwise.
        ``accumulate_grad_batches`` is accepted and not used, as in the
        reference."""
        self._build_steps()
        if supervisor is not None:
            self._build_guarded_step(supervisor.anomaly.check_grads)
            ds = (train_data.dataset if isinstance(train_data, DataLoader)
                  else train_data)
            if isinstance(ds, IterableDataset):
                # an iterable stream has no index space: the exact-
                # resume contract CANNOT hold — refuse loudly rather
                # than stamp cursors that silently lie on resume
                raise ValueError(
                    "supervised fit needs a map-style dataset for its "
                    "exact-resume contract; IterableDataset streams "
                    "cannot be cursored. Use TrainSupervisor.run with "
                    "a resumable loader instead.")
        if isinstance(train_data, DataLoader):
            loader = train_data
        elif supervisor is not None:
            sampler = DistributedBatchSampler(
                train_data, batch_size=batch_size, num_replicas=1, rank=0,
                shuffle=shuffle, drop_last=drop_last)
            loader = DataLoader(train_data, batch_sampler=sampler,
                                num_workers=num_workers)
        else:
            loader = DataLoader(train_data, batch_size=batch_size,
                                shuffle=shuffle, drop_last=drop_last,
                                num_workers=num_workers)
        cbs = CallbackList(callbacks or [ProgBarLogger(log_freq,
                                                       verbose=verbose)])
        cbs.set_model(self)
        cbs.on_train_begin()
        self.stop_training = False     # a new fit() is a new run
        rng = prng.PRNGKey(0)
        start_epoch, skip_batches = 0, 0
        if supervisor is not None:
            # a pending preemption belonged to the run it interrupted;
            # re-invoking IS the resume, so start with a clean flag
            supervisor.clear_preemption()
            restored = self._restore_fit(supervisor)
            if restored is not None:
                rng, start_epoch, skip_batches = restored
        preempted = False
        epoch = start_epoch
        while epoch < epochs:
            sampler = getattr(loader, "batch_sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            cbs.on_epoch_begin(epoch)
            logs = {}
            # mid-epoch resume: skip the already-trained prefix at the
            # sampler level, keeping `it` aligned with absolute batch
            # indices for the cursor
            skip = skip_batches if epoch == start_epoch else 0
            batches = loader.resume_iter(skip)
            it = skip - 1
            stop_cursor = None         # set on ANY mid-epoch stop: the
            #                            next unprocessed batch index
            rolled_back = False        # anomaly rollback: restart the
            #                            epoch loop at the restored cursor
            while True:
                if supervisor is not None:
                    # retry INJECTED data faults only; the actual
                    # next() runs unretried — a generator that raised
                    # is closed, and re-nexting it would read as a
                    # silently truncated epoch
                    supervisor.run_with_retries(lambda: None,
                                                _faults.DATA_NEXT)
                try:
                    batch = next(batches)
                except StopIteration:
                    break
                it += 1
                if num_iters is not None and self._step_count >= num_iters:
                    stop_cursor = it             # batch `it` not run
                    break
                if supervisor is not None and supervisor.preempted:
                    preempted = True
                    stop_cursor = it
                    break
                cbs.on_train_batch_begin(it)
                inputs, labels = self._split(batch)
                self._step_count += 1
                keys = prng.split(rng)
                rng, sub = keys[0], keys[1]
                if supervisor is None:
                    loss = self._step_fn(inputs, labels, self._step_count,
                                         sub, self._cur_lr())
                    rb = None
                else:
                    loss, rb = self._supervised_step(
                        supervisor, inputs, labels, sub, epoch, it, rng)
                logs = {"loss": float(loss), "step": it}
                cbs.on_train_batch_end(it, logs)
                if rb is not None:
                    # anomaly rollback restored the checkpoint's params
                    # AND its data cursor + rng: rewind the loop to
                    # replay the same batches from the same state
                    rng, start_epoch, skip_batches = rb
                    rolled_back = True
                    break
                if self.stop_training:
                    stop_cursor = it + 1         # batch `it` ran
                    break
            if rolled_back:
                epoch = start_epoch
                continue
            if preempted:
                supervisor.note_preempt()
                supervisor.save_state(
                    self._step_count, self._ckpt_state(),
                    self._fit_meta(epoch, stop_cursor, rng), force=True)
                supervisor.wait_for_saves()
                self.stop_training = True
                break
            if supervisor is not None and stop_cursor is not None:
                # mid-epoch stop (num_iters / early stopping): the
                # durable cursor must say the epoch is UNFINISHED
                supervisor.save_state(
                    self._step_count, self._ckpt_state(),
                    self._fit_meta(epoch, stop_cursor, rng), force=True)
            if hasattr(self._optimizer._lr, "step"):
                try:
                    self._optimizer._lr.step()
                except TypeError:
                    pass
            cbs.on_epoch_end(epoch, logs)
            if supervisor is not None and stop_cursor is None:
                # end-of-epoch durability point: cursor rolls to the
                # next epoch so resume never replays a finished one
                supervisor.save_state(
                    self._step_count, self._ckpt_state(),
                    self._fit_meta(epoch + 1, 0, rng), force=True)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size,
                              verbose=verbose)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch_{epoch}")
            if self.stop_training:
                break
            if supervisor is not None and num_iters is not None and \
                    self._step_count >= num_iters:
                # stop the EPOCH loop too: spinning through the
                # remaining epochs would re-save the cursor as
                # (epoch, 0) each time, advancing the resume point past
                # data that was never trained. Plain fit keeps the
                # reference's behavior (remaining epochs still run their
                # epoch-end eval/save/LR hooks with zero batches).
                break
            epoch += 1
        if supervisor is not None:
            supervisor.wait_for_saves()
        cbs.on_train_end()
        return self

    def _supervised_step(self, supervisor, inputs, labels, sub, epoch,
                         it, rng):
        """One guarded train step under the supervisor: retry transient
        failures, skip non-finite updates, roll back after K in a row,
        checkpoint on the save interval. Returns ``(loss, rollback)``;
        ``rollback`` is None, or ``(rng, epoch, batch)`` — the restored
        checkpoint's cursor the fit loop must rewind to."""
        def run():
            return self._gstep_fn(inputs, labels, self._step_count, sub,
                                  self._cur_lr())

        loss, loss_fin, grad_fin = supervisor.run_with_retries(
            run, _faults.TRAIN_STEP)
        if loss_fin and grad_fin:
            supervisor.note_ok()
            supervisor.save_state(self._step_count, self._ckpt_state(),
                                  lambda: self._fit_meta(epoch, it + 1, rng))
            return loss, None
        kind = (_rt.ANOMALY_NONFINITE_LOSS if not loss_fin
                else _rt.ANOMALY_NONFINITE_GRAD)
        action = supervisor.note_anomaly(kind, step=self._step_count)
        if action != "rollback":
            return loss, None
        state, meta, done = supervisor.restore_state()
        if done is None:
            # mirror TrainSupervisor.run: continuing here would
            # silently burn the rollback budget restoring nothing
            raise _rt.TrainAnomalyError(
                "anomalies before any checkpoint existed: "
                "nothing to roll back to", kind=kind,
                step=self._step_count)
        # full rollback — params/opt, LR schedule, global RNG, AND the
        # data cursor + fit rng chain: the loop rewinds and replays the
        # same batches from the same state, exactly like kill+resume
        self._apply_checkpoint(state, meta)
        return loss, self._fit_cursor(meta)

    @torch.no_grad()
    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        self._build_steps()
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size,
                       num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for it, batch in enumerate(loader):
            if num_iters is not None and it >= num_iters:
                break
            inputs, labels = self._split(batch)
            out = self.network(*inputs)
            losses.append(float(self._loss(out, *labels)))
            out, labels = _host(out), [_host(x) for x in labels]
            for m in self._metrics:
                m.update(m.compute(out, *labels)) \
                    if m.__class__.__name__ == "Accuracy" else \
                    m.update(out, *labels)
        res = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            res[m.name() if isinstance(m.name(), str) else m.name()[0]] = \
                m.accumulate()
        return res

    @torch.no_grad()
    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        self._build_steps()
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        outs = []
        for batch in loader:
            inputs, _ = self._split(batch)
            outs.append(_host(self.network(*inputs)))
        if stack_outputs:
            return [np.concatenate(outs, axis=0)]
        return [outs]

    def train_batch(self, inputs, labels=None, update=True):
        self._build_steps()
        inputs, labels = self._as_batch(inputs), self._as_batch(labels)
        self._step_count += 1
        loss = self._step_fn(inputs, labels, self._step_count,
                             prng.PRNGKey(self._step_count), self._cur_lr())
        return [float(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self._build_steps()
        inputs, labels = self._as_batch(inputs), self._as_batch(labels)
        return [float(self._loss(self.network(*inputs), *labels))]

    @torch.no_grad()
    def predict_batch(self, inputs):
        self._build_steps()
        return [_host(self.network(*self._as_batch(inputs)))]

    # ---------------------------------------------------------------- io
    def save(self, path, training=True):
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict() if self._opt_state is None
                 else {"state": self._opt_state, "step": self._step_count},
                 path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        set_state_dict(self.network, load(path + ".pdparams"))
        self._params = None
        self._step_fn = None
        return self

    def parameters(self, *a, **k):
        return self.network.parameters(*a, **k)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary
        return summary(self.network, input_size)

"""hapi callbacks (reference python/paddle/hapi/callbacks.py).

Port of ``paddle_tpu/hapi/callbacks.py`` (framework-free).
``TelemetryCallback`` (step time, loss and tokens per second into a
telemetry registry) lives in ``telemetry.training`` and is re-exported
here, as in the reference.
"""
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "VisualDL", "ReduceLROnPlateau",
           "WandbCallback", "TelemetryCallback"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                # fire EVERY callback even when one raises (mirrors the
                # serving _fire_callbacks contract: a poisoned logger
                # must not starve EarlyStopping/checkpointing), then
                # re-raise the failures together, first as __cause__
                errors = []
                for c in self.callbacks:
                    try:
                        getattr(c, name)(*args, **kwargs)
                    except Exception as e:
                        errors.append((type(c).__name__, e))
                if errors:
                    from ..reliability.errors import CallbackError
                    raise CallbackError(errors, what=f"{name} callback")
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._t0 = time.perf_counter()
        self._steps = 0

    def on_train_batch_end(self, step, logs=None):
        self._steps += 1
        if self.verbose and step % self.log_freq == 0:
            loss = logs.get("loss")
            dt = time.perf_counter() - self._t0
            ips = self._steps / dt if dt > 0 else 0
            print(f"Epoch {self.epoch}: step {step}, loss "
                  f"{loss:.5f}, {ips:.2f} step/s")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch} done: {logs}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur if np.isscalar(cur) else np.asarray(cur).mean())
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor

    def on_epoch_end(self, epoch, logs=None):
        pass  # the LR scheduler object handles this in paddle_tpu


class VisualDL(Callback):
    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._rows = []

    def on_train_batch_end(self, step, logs=None):
        self._rows.append({"step": step, **(logs or {})})

    def on_train_end(self, logs=None):
        import json
        import os
        os.makedirs(self.log_dir, exist_ok=True)
        with open(f"{self.log_dir}/scalars.jsonl", "w") as f:
            for r in self._rows:
                f.write(json.dumps(r) + "\n")


class WandbCallback(Callback):
    """Weights & Biases logger (reference hapi/callbacks.py WandbCallback).
    Degrades to a JSONL metric log when the wandb package is absent
    (zero-egress environments)."""

    def __init__(self, project=None, dir=None, **kwargs):  # noqa: A002
        self._project = project
        self._dir = dir or "."
        self._kwargs = kwargs
        try:
            import wandb
            self._wandb = wandb
        except ImportError:
            self._wandb = None
            self._fallback_path = None

    def on_train_begin(self, logs=None):
        if self._wandb is not None:
            self._run = self._wandb.init(project=self._project,
                                         dir=self._dir, **self._kwargs)
        else:
            import os
            self._fallback_path = os.path.join(self._dir,
                                               "wandb_fallback.jsonl")

    def _log(self, logs):
        if self._wandb is not None:
            self._run.log(logs)
        elif self._fallback_path:
            import json
            clean = {k: float(v) for k, v in (logs or {}).items()
                     if isinstance(v, (int, float))}
            with open(self._fallback_path, "a") as f:
                f.write(json.dumps(clean) + "\n")

    def on_epoch_end(self, epoch, logs=None):
        self._log(dict(logs or {}, epoch=epoch))

    def on_train_end(self, logs=None):
        if self._wandb is not None:
            self._run.finish()


# telemetry bridge (step time / loss / tokens-per-second into a
# MetricRegistry); lives in telemetry.training, duck-typed against the
# Callback protocol so the import direction stays telemetry -> nothing
from ..telemetry.training import TelemetryCallback  # noqa: E402,F401

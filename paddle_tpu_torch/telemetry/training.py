"""Training-side telemetry bridge (hapi callback).

Copied from ``paddle_tpu/telemetry/training.py`` (framework-free).

``TelemetryCallback`` rides ``Model.fit(callbacks=[...])`` and publishes
the training loop's vital signs into a ``MetricRegistry``:

- ``train_step_seconds``      histogram, batch-to-batch wall time
- ``train_loss``              gauge, last reported loss
- ``train_steps_total``       counter
- ``train_samples_total``     counter (when ``samples_per_batch`` set)
- ``train_tokens_total``      counter (when ``tokens_per_batch`` set)
- ``train_throughput``        gauge, steps/s (or samples/s / tokens/s
                              when the corresponding rate base is set)

plus per-epoch trace spans. Duck-typed against hapi's ``Callback``
protocol (``CallbackList`` dispatches via ``getattr``) so importing
this module never pulls ``hapi`` in — ``hapi.callbacks`` re-exports it
for discoverability without a cycle.
"""
from .clock import MonotonicClock
from .metrics import MetricRegistry

__all__ = ["TelemetryCallback", "STEP_BUCKETS"]

STEP_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0, 60.0, 300.0)


class TelemetryCallback:
    """hapi callback publishing step time / loss / throughput.

    >>> tele = telemetry.ServerTelemetry()         # or bare registry
    >>> model.fit(data, callbacks=[
    ...     TelemetryCallback(registry, tokens_per_batch=B * T)])
    """

    def __init__(self, registry=None, tracer=None, clock=None,
                 samples_per_batch=None, tokens_per_batch=None):
        self.registry = registry if registry is not None \
            else MetricRegistry()
        self.clock = clock if clock is not None else MonotonicClock()
        self.tracer = tracer
        self.enabled = self.registry.enabled
        self._samples_per_batch = samples_per_batch
        self._tokens_per_batch = tokens_per_batch
        r = self.registry
        self._h_step = r.histogram("train_step_seconds",
                                   "Train batch wall time",
                                   buckets=STEP_BUCKETS)
        self._g_loss = r.gauge("train_loss", "Last reported train loss")
        self._c_steps = r.counter("train_steps_total", "Train batches")
        self._c_samples = r.counter("train_samples_total",
                                    "Samples consumed")
        self._c_tokens = r.counter("train_tokens_total",
                                   "Tokens consumed")
        self._g_tput = r.gauge("train_throughput",
                               "steps/s (samples/s or tokens/s when a "
                               "per-batch base is configured)")
        self._t_batch = None
        self._epoch_span = None
        self.model = None
        self.params = {}

    # --------------------------------------------- hapi Callback protocol
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        if self.tracer is not None:
            self._epoch_span = self.tracer.begin_span("train.epoch",
                                                      epoch=epoch)

    def on_epoch_end(self, epoch, logs=None):
        if self._epoch_span is not None:
            self._epoch_span.end()
            self._epoch_span = None

    def on_train_batch_begin(self, step, logs=None):
        if self.enabled:
            self._t_batch = self.clock.now()

    def on_train_batch_end(self, step, logs=None):
        if not self.enabled:
            return
        now = self.clock.now()
        self._c_steps.inc()
        base = 1.0
        if self._samples_per_batch:
            self._c_samples.inc(self._samples_per_batch)
            base = float(self._samples_per_batch)
        if self._tokens_per_batch:
            self._c_tokens.inc(self._tokens_per_batch)
            base = float(self._tokens_per_batch)
        if self._t_batch is not None:
            dt = now - self._t_batch
            self._h_step.observe(dt)
            if dt > 0:
                self._g_tput.set(base / dt)
            self._t_batch = None
        loss = (logs or {}).get("loss")
        if loss is not None:
            self._g_loss.set(float(loss))

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

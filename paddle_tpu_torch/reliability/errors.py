"""Typed errors for the serving and training reliability layers.

Copied from ``paddle_tpu/reliability/errors.py``, cut to the failures
the port raises: the server's, the fault injector's, the durable
checkpoints' and the training supervisor's.

Every failure the reliability layer can hand a waiter is a
``ReliabilityError`` subclass, so callers can catch the whole family or
match a specific condition. ``ContinuousBatchingServer.wait`` raises
these DIRECTLY (no RuntimeError wrapping) — a client distinguishing
"shed, resubmit later" (``QueueFullError``) from "never resubmit"
(``DeadlineExceeded``) only needs the type.
"""

__all__ = ["ReliabilityError", "DeadlineExceeded", "QueueFullError",
           "RequestCancelled", "ServerClosed", "CallbackError",
           "CircuitOpenError", "InjectedFault", "CheckpointCorruptError",
           "TrainAnomalyError", "StepFailedError"]


class ReliabilityError(RuntimeError):
    """Base class for every typed serving-reliability failure."""


class DeadlineExceeded(ReliabilityError, TimeoutError):
    """The request's ``deadline_s`` elapsed before it finished. Raised
    at submit (deadline already in the past), while queued (expired
    before a prefill was spent on it), or surfaced as a PARTIAL result
    when a mid-decode request runs out of time (the server cancels the
    slot and records what it generated)."""


class QueueFullError(ReliabilityError):
    """Admission control shed this request: the queue held ``max_queue``
    entries. Under ``shed_policy="reject"`` the NEW submit raises this;
    under ``"evict_oldest"`` the OLDEST queued request fails with it
    (its waiter sees the eviction) and the new one is accepted."""


class RequestCancelled(ReliabilityError):
    """``cancel()`` dropped the request while it was still queued (a
    mid-decode cancel records the partial result instead)."""


class ServerClosed(ReliabilityError):
    """The server is draining or stopped: submits are refused, and a
    hard ``stop()`` fails still-queued requests with this."""


class CircuitOpenError(ReliabilityError):
    """The serve loop's circuit breaker opened (N consecutive tick
    failures): in-flight and queued requests are failed with this so no
    waiter wedges, and the server goes ``degraded`` until a half-open
    probe tick succeeds. ``__cause__`` is the last tick error."""


class InjectedFault(ReliabilityError):
    """A ``FaultInjector`` failure point fired (chaos testing)."""

    def __init__(self, point="", visit=None):
        self.point = point
        self.visit = visit
        msg = point if visit is None else f"{point} (visit {visit})"
        super().__init__(f"injected fault at {msg}")


class CheckpointCorruptError(ReliabilityError):
    """A checkpoint directory failed integrity verification: missing
    manifest, missing leaf file, byte-count mismatch, or a per-leaf
    checksum that does not match the manifest. ``restore()`` raises this
    for an explicit step; latest-checkpoint restore SKIPS corrupt
    directories and falls back to the newest checkpoint that verifies."""

    def __init__(self, path, reason=""):
        self.path = str(path)
        self.reason = reason
        msg = self.path if not reason else f"{self.path}: {reason}"
        super().__init__(f"corrupt checkpoint at {msg}")


class TrainAnomalyError(ReliabilityError):
    """The supervised train loop gave up on anomalies: K consecutive
    non-finite losses/grads persisted through ``max_rollbacks``
    rollbacks to the last good checkpoint. ``kind`` is the last anomaly
    kind observed (``nonfinite_loss`` / ``nonfinite_grad``)."""

    def __init__(self, msg, kind="nonfinite_loss", step=None):
        self.kind = kind
        self.step = step
        super().__init__(msg)


class StepFailedError(ReliabilityError):
    """A train step (or data fetch) kept failing after the supervisor's
    retry budget was exhausted (or its circuit breaker opened).
    ``__cause__`` is the last underlying error."""


class CallbackError(ReliabilityError):
    """One or more callbacks raised during a fire-them-all sweep
    (serving ``on_token`` streams, hapi ``CallbackList`` events). EVERY
    queued callback still fires (one poisoned callback must not starve
    the others); this carries the per-callback errors so the caller can
    fail exactly the offending parties.

    ``rid``/``__cause__`` are the first failure; ``errors`` is the full
    ``[(rid_or_name, exception), ...]`` list in firing order."""

    def __init__(self, errors, what="callback"):
        self.errors = list(errors)
        self.rid, first = self.errors[0]
        super().__init__(
            f"{len(self.errors)} {what}(s) raised; first: "
            f"{self.rid}: {first!r}")
        self.__cause__ = first

"""Typed errors for the serving and training reliability layers.

Copied from ``paddle_tpu/reliability/errors.py``, cut to the failures
the port raises: the server's (its preemption signal included), the
fleet's (the router's lost replica, a migration attempt, and the wire's
``TransportError`` and ``FrameError`` between a router and its process
replicas), the batch scheduler's, the fault injector's, the durable checkpoints' and the
training supervisor's.

Every failure the reliability layer can hand a waiter is a
``ReliabilityError`` subclass, so callers can catch the whole family or
match a specific condition. ``ContinuousBatchingServer.wait`` raises
these DIRECTLY (no RuntimeError wrapping) — a client distinguishing
"shed, resubmit later" (``QueueFullError``) from "never resubmit"
(``DeadlineExceeded``) only needs the type.
"""

__all__ = ["ReliabilityError", "DeadlineExceeded", "QueueFullError",
           "RequestCancelled", "ServerClosed", "SchedulerClosed",
           "CallbackError",
           "CircuitOpenError", "ReplicaLostError", "PreemptedError",
           "MigrationError", "InjectedFault", "TransportError",
           "FrameError", "CheckpointCorruptError", "TrainAnomalyError",
           "StepFailedError"]


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


class SchedulerClosed(ReliabilityError):
    """``BatchScheduler.close()`` gave up on a wedged runner, or a submit
    reached a closed scheduler; pending futures are failed with this
    instead of hanging forever."""


class CircuitOpenError(ReliabilityError):
    """The serve loop's circuit breaker opened (N consecutive tick
    failures): in-flight and queued requests are failed with this so no
    waiter wedges, and the server goes ``degraded`` until a half-open
    probe tick succeeds. ``__cause__`` is the last tick error."""


class ReplicaLostError(ReliabilityError):
    """The multi-replica router could not place (or re-place) this
    request on ANY replica: no replica was serving at submit, or the
    replica holding it died and the requeue found the whole fleet
    down (while any sibling is alive the router HOLDS the request and
    keeps retrying instead). ``__cause__`` is the last per-replica
    error. Request-level outcomes pass through the router unchanged —
    ``DeadlineExceeded``, ``RequestCancelled``, ``CallbackError``, and
    a replica's breaker opening (``CircuitOpenError``, deliberately
    fail-fast: its in-flight work may already have streamed tokens, so
    transparent re-execution would double-stream)."""


class TransportError(ReliabilityError):
    """A wire-transport failure between a router and a remote replica
    (``inference/transport.py``): the connection died, was severed by
    an injected ``net.*`` fault, or a call's reply never arrived. It
    marks exactly ONE call's outcome — the request may still be alive
    on the remote host, so the router treats it like any transient
    dispatch failure (breaker + failover), never as a request
    verdict."""


class FrameError(TransportError):
    """One frame on the wire was unusable — truncated payload, a
    length prefix past the frame cap, or bytes that do not decode as a
    JSON object. The receiver fails the affected call (or drops the
    frame when no call can be attributed) and, unless the stream lost
    sync (oversize/truncation), keeps serving the connection."""


class MigrationError(ReliabilityError):
    """A live KV-page migration attempt could not complete: the request
    is not migratable (unknown, finished, dense backend, already in
    flight), a gathered or received page failed its sha256 check, or
    the two ends disagree on page geometry or role. It marks exactly ONE
    migration attempt's outcome — the request itself is STILL LIVE on
    the source (paused at worst, resumed by ``migrate_abort``) — so
    callers degrade to the evacuate+replay path
    (``server_migrations_total{result=fallback}``) and NEVER surface
    this to a waiter."""


class PreemptedError(ReliabilityError):
    """INTERNAL scheduling signal of ``admission="optimistic"``: the
    server preempted this request's slot under KV-pool pressure (its
    pages were freed, its written prompt prefix donated to the prefix
    cache) and parked it on the preempted queue for bit-exact
    re-admission. It is typed so the scheduler's own control flow and
    the chaos tests can match it precisely, but it is NOT a request
    outcome: a preempted request is still live, its waiter keeps
    blocking, and ``wait()`` NEVER raises this. A preempted request
    ultimately resolves like any other: result, partial (deadline,
    cancel, hard stop), or a different typed failure."""


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

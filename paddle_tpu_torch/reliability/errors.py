"""Typed errors for the serving reliability layer.

Copied from ``paddle_tpu/reliability/errors.py``, cut to the failures
the port's server raises.

Every failure the reliability layer can hand a waiter is a
``ReliabilityError`` subclass, so callers can catch the whole family or
match a specific condition. ``ContinuousBatchingServer.wait`` raises
these DIRECTLY (no RuntimeError wrapping) — a client distinguishing
"shed, resubmit later" (``QueueFullError``) from "never resubmit"
(``DeadlineExceeded``) only needs the type.
"""

__all__ = ["ReliabilityError", "DeadlineExceeded", "QueueFullError",
           "RequestCancelled", "ServerClosed", "CallbackError"]


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

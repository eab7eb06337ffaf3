"""Structured error system (reference paddle/fluid/platform/enforce.h:
PADDLE_ENFORCE_* macros raising typed platform errors with context).

Port of ``paddle_tpu/utils/enforce.py``, framework-free and copied as it
is: plain-Python typed exceptions with the reference's taxonomy
(InvalidArgument/NotFound/OutOfRange/AlreadyExists/PermissionDenied/
Unimplemented/Unavailable/Fatal/ExecutionTimeout ...), a summarized
traceback like the reference's demangled stack, and enforce helpers the
framework and user custom ops can call.
"""
from __future__ import annotations

import traceback

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError", "PermissionDeniedError",
           "UnimplementedError", "UnavailableError", "FatalError",
           "ExecutionTimeoutError", "enforce", "enforce_eq", "enforce_gt",
           "enforce_ge", "enforce_shape", "enforce_not_none"]


class EnforceNotMet(RuntimeError):
    """Base of all enforce failures (reference EnforceNotMet). Carries the
    error-type tag and a compact python stack summary."""

    error_type = "Error"

    def __init__(self, message, hint=None):
        self.hint = hint
        # trim only this __init__'s frame so a direct `raise TypedError`
        # keeps its raise site in the summary (enforce() callers show the
        # enforce frame too, which is accurate)
        frames = traceback.extract_stack()[:-1]
        tail = "".join(traceback.format_list(frames[-3:]))
        full = f"{self.error_type}: {message}"
        if hint:
            full += f"\n  [Hint: {hint}]"
        full += f"\n\n  [operator stack]\n{tail}"
        super().__init__(full)
        self.raw_message = message


class InvalidArgumentError(EnforceNotMet):
    error_type = "InvalidArgumentError"


class NotFoundError(EnforceNotMet):
    error_type = "NotFoundError"


class OutOfRangeError(EnforceNotMet):
    error_type = "OutOfRangeError"


class AlreadyExistsError(EnforceNotMet):
    error_type = "AlreadyExistsError"


class PermissionDeniedError(EnforceNotMet):
    error_type = "PermissionDeniedError"


class UnimplementedError(EnforceNotMet):
    error_type = "UnimplementedError"


class UnavailableError(EnforceNotMet):
    error_type = "UnavailableError"


class FatalError(EnforceNotMet):
    error_type = "FatalError"


class ExecutionTimeoutError(EnforceNotMet):
    error_type = "ExecutionTimeoutError"


def enforce(cond, message="enforce failed", error_cls=InvalidArgumentError,
            hint=None):
    """PADDLE_ENFORCE: raise the typed error when cond is falsy."""
    if not cond:
        raise error_cls(message, hint=hint)
    return True


def enforce_eq(a, b, message=None, error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(message or f"expected {a!r} == {b!r}")
    return True


def enforce_gt(a, b, message=None, error_cls=InvalidArgumentError):
    if not a > b:
        raise error_cls(message or f"expected {a!r} > {b!r}")
    return True


def enforce_ge(a, b, message=None, error_cls=InvalidArgumentError):
    if not a >= b:
        raise error_cls(message or f"expected {a!r} >= {b!r}")
    return True


def enforce_shape(x, shape, name="tensor"):
    """Check a tensor/array shape against a spec with -1 wildcards."""
    actual = tuple(getattr(x, "shape", ()))
    if len(actual) != len(shape) or any(
            s not in (-1, None) and int(s) != int(a)
            for s, a in zip(shape, actual)):
        raise InvalidArgumentError(
            f"{name} shape mismatch: expected {list(shape)}, got "
            f"{list(actual)}")
    return True


def enforce_not_none(x, name="value"):
    if x is None:
        raise NotFoundError(f"{name} must not be None")
    return x

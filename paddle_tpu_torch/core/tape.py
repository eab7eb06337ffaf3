"""Gradient recording switches of the tensor API.

Port of ``paddle_tpu/core/tape.py``. The reference records a tape of
``jax.vjp`` closures and walks it in reverse creation order; the port
has no tape of its own: torch's autograd records the graph, so these
are torch's grad mode (thread-local, as the reference's flag is) under
the reference's names. There is no ``Node``.
"""
import torch

__all__ = ["tape_enabled", "no_grad", "enable_grad", "set_grad_enabled"]


def tape_enabled() -> bool:
    return torch.is_grad_enabled()


def no_grad():
    """Disable gradient recording (a context manager and a decorator)."""
    return torch.no_grad()


def enable_grad():
    return torch.enable_grad()


def set_grad_enabled(mode: bool):
    """Switch recording on or off for this thread (a plain call, as in
    the reference)."""
    torch.set_grad_enabled(bool(mode))

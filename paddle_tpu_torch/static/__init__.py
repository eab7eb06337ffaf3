"""paddle.static's ``InputSpec``: the shape, dtype and name of an
exported program's feed.

Port of ``InputSpec`` from ``paddle_tpu/static/program.py:17-36``. A
``-1`` or ``None`` dim is dynamic: ``inference.export_layer`` exports it
as a ``torch.export.Dim``. The rest of ``static`` (``Program``,
``Executor``, ``data``, the static ``nn``) is ROADMAP Queue 1 item 15.
"""
import torch

__all__ = ["InputSpec"]

# an example size for a dynamic dim: torch.export specialises a dim whose
# example size is 0 or 1 (the reference's placeholder size is 1)
DYNAMIC_EXAMPLE_SIZE = 2


def _dtype(dtype):
    """A dtype name (``"float32"``, ``"bfloat16"``, ``"int64"``, ...) or a
    ``torch.dtype`` as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


class InputSpec:
    """Shape/dtype/name spec (python/paddle/static/input.py InputSpec)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape),
                   str(tensor.dtype).replace("torch.", ""), name)

    def dynamic_dims(self):
        """Indices of the dims that are ``-1`` or ``None``."""
        return [i for i, d in enumerate(self.shape) if d is None or d == -1]

    def example(self, device=None):
        """A zero tensor of this spec on ``device``, each dynamic dim at
        ``DYNAMIC_EXAMPLE_SIZE``: what ``export_layer`` traces with."""
        shape = [DYNAMIC_EXAMPLE_SIZE if (d is None or d == -1) else int(d)
                 for d in self.shape]
        return torch.zeros(shape, dtype=_dtype(self.dtype), device=device)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")

"""paddle.incubate's LookAhead and ModelAverage over the port's
optimizers.

Port of ``paddle_tpu/incubate/optimizer.py``. Both keep their own
copies of the weights (the slow weights, the running sum) and write
the parameters in place under ``torch.no_grad``.
"""
import contextlib

import torch

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """k steps forward, 1 step back: wraps an inner optimizer; every
    ``k`` inner steps the slow weights catch up, ``slow += alpha * (fast
    - slow)``, and the parameters become the slow weights."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        self._slow = None
        self._params = list(getattr(inner_optimizer, "_parameters",
                                    None) or [])

    def _ensure_slow(self):
        if self._slow is None:
            self._slow = [p.detach().clone() for p in self._params]

    @torch.no_grad()
    def step(self):
        self._ensure_slow()
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for i, p in enumerate(self._params):
                slow = self._slow[i] + self.alpha * (p - self._slow[i])
                self._slow[i] = slow
                p.copy_(slow)

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["lookahead_step"] = self._step_count
        return sd

    def set_state_dict(self, sd):
        self._step_count = sd.pop("lookahead_step", 0)
        self.inner_optimizer.set_state_dict(sd)

    def get_lr(self):
        return self.inner_optimizer.get_lr()


class ModelAverage:
    """The running average of the parameters, applied for evaluation:
    ``step()`` adds the current weights to the sum; the ``apply()``
    context swaps the average in and (``need_restore``) the weights back
    on exit; ``restore()`` swaps them back."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000000,
                 name=None):
        self._params = list(parameters or [])
        self._sum = [torch.zeros_like(p, requires_grad=False)
                     for p in self._params]
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        """Add the current weights to the sum."""
        for i, p in enumerate(self._params):
            self._sum[i] = self._sum[i] + p
        self._count += 1

    # paddle's name: the average accumulates after the inner step
    update = step

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            yield
            return
        with torch.no_grad():
            self._backup = [p.detach().clone() for p in self._params]
            for i, p in enumerate(self._params):
                p.copy_(self._sum[i] / self._count)
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is not None:
            for p, b in zip(self._params, self._backup):
                p.copy_(b)
            self._backup = None

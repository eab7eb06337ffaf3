"""Optimizer base, Adam and AdamW.

Port of the matching part of ``paddle_tpu/optimizer/optimizer.py``. The
update is the JAX package's ``Adam._update_leaf``, operation for
operation: moments in f32 for bf16/fp16 parameters (``_zeros_tree``),
bias corrections computed in f32 from the 1-based step, ``upd =
mhat / (sqrt(vhat) + eps)`` plus ``wd * p`` for AdamW (decoupled) or
``g + wd * p`` for Adam (L2), then ``p - lr * upd`` rounded back to the
parameter's dtype, or kept in an f32 master copy with
``multi_precision``. ``torch.optim.AdamW`` is not used: it decays the
parameter before the Adam step, a different rounding of a different
order.

The JAX package's optimizer is functional (new parameters and state out
of every update); this one updates the parameters and its state in
place, under ``torch.no_grad``, and keeps the state by parameter index
as the JAX object API does (``state_dict()["state"]["m"]["0"]``).
Learning-rate schedulers and gradient clipping are not ported yet and
raise ``NotImplementedError`` (ROADMAP, Queue 1 item 3).
"""
import numbers

import numpy as np
import torch

__all__ = ["Optimizer", "Adam", "AdamW"]

_TODO = "ROADMAP, Queue 1 item 3: the rest of the training stack"


def _moment_dtype(p):
    # moments live in f32 even for fp16/bf16 parameters: fp16 moments
    # flush v ~ g^2 < 6e-8 to zero and mhat / (sqrt(0) + eps) explodes
    return torch.float32 if p.dtype in (torch.float16, torch.bfloat16) \
        else p.dtype


class Optimizer:
    """``parameters``: an iterable of ``nn.Parameter``, or of ``(name,
    parameter)`` pairs (``model.named_parameters()``) so that
    ``apply_decay_param_fun`` can read each parameter's name. A
    parameter with ``requires_grad=False`` is not trained; one whose
    ``.grad`` is None is skipped by a step."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                f"learning-rate schedulers are not ported ({_TODO}); pass "
                f"a number")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip is not ported ({_TODO})")
        self._lr = float(learning_rate)
        self._names, self._parameters = [], []
        for item in (parameters if parameters is not None else []):
            name_, p = item if isinstance(item, tuple) else \
                (getattr(item, "name", None), item)
            self._names.append(name_)
            self._parameters.append(p)
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._opt_state = None
        self._step_count = 0

    # ------------------------------------------------------------- lr
    def get_lr(self):
        return self._lr

    def set_lr(self, value):
        self._lr = float(value)

    # ----------------------------------------------------------- state
    def init_state(self, params):
        """{state name: {str(i): tensor}} for the parameters ``params``
        ({str(i): tensor})."""
        return {}

    def _wd_for(self, i):
        if getattr(self._parameters[i], "no_weight_decay", False):
            return 0.0
        return self._weight_decay

    def _update_leaf(self, g, p, state, lr, step, wd):
        """(new value of p, in f32 where it is kept there; new state)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter that has a gradient;
        the step count (1-based in the bias corrections) advances once."""
        live = [i for i, p in enumerate(self._parameters)
                if p.requires_grad and p.grad is not None]
        if not live:
            return
        if self._opt_state is None:
            self._opt_state = self.init_state(
                {str(i): p for i, p in enumerate(self._parameters)})
        self._step_count += 1
        lr = self.get_lr()
        for i in live:
            k = str(i)
            p = self._parameters[i]
            leaf = {n: st[k] for n, st in self._opt_state.items()}
            new_p, new_state = self._update_leaf(
                p.grad, p, leaf, lr, self._step_count,
                float(self._wd_for(i) or 0.0))
            p.copy_(new_p)                 # rounds to p's dtype
            for n, v in new_state.items():
                self._opt_state[n][k] = v

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        sd = {"step": self._step_count}
        if self._opt_state is not None:
            sd["state"] = self._opt_state
        return sd

    def set_state_dict(self, sd):
        self._step_count = sd.get("step", 0)
        if "state" in sd:
            if getattr(self, "_multi_precision", False) \
                    and "master" not in sd["state"]:
                raise ValueError(
                    "multi_precision=True but the checkpoint has no "
                    "'master' tree (saved without multi_precision): "
                    "resave with multi_precision or construct the optimizer "
                    "without it")
            self._opt_state = sd["state"]


class Adam(Optimizer):
    """Adam with L2 weight decay (``g + wd * p``), f32 moments for
    low-precision parameters and, with ``multi_precision``, f32 master
    weights for them (an f32 parameter keeps a 0-size sentinel)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        if lazy_mode:
            raise NotImplementedError(f"lazy_mode is not ported ({_TODO})")
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._decoupled_wd = False
        self._multi_precision = multi_precision

    def init_state(self, params):
        st = {"m": {k: torch.zeros_like(p, dtype=_moment_dtype(p))
                    for k, p in params.items()}}
        st["v"] = {k: torch.zeros_like(m) for k, m in st["m"].items()}
        if self._multi_precision:
            st["master"] = {
                k: (p.detach().float().clone() if p.dtype != torch.float32
                    else torch.zeros((0,), dtype=torch.float32,
                                     device=p.device))
                for k, p in params.items()}
        return st

    def _bias_correction(self, beta, step):
        # f32 arithmetic, as the JAX update computes 1 - beta ** step
        return float(np.float32(1) - np.float32(beta) ** np.float32(step))

    def _update_leaf(self, g, p, state, lr, step, wd):
        g32 = g.float()
        master = state.get("master")
        use_master = master is not None and master.numel() > 0
        p32 = master if use_master else p.float()
        if wd and not self._decoupled_wd:
            g32 = g32 + wd * p32
        m = self._beta1 * state["m"] + (1 - self._beta1) * g32
        v = self._beta2 * state["v"] + (1 - self._beta2) * g32.square()
        mhat = m / self._bias_correction(self._beta1, step)
        vhat = v / self._bias_correction(self._beta2, step)
        upd = mhat / (vhat.sqrt() + self._eps)
        if wd and self._decoupled_wd:
            upd = upd + wd * p32
        new_p32 = p32 - lr * upd
        out = {"m": m, "v": v}
        if master is not None:
            out["master"] = new_p32 if use_master else master
        return new_p32, out


class AdamW(Adam):
    """Adam with decoupled weight decay (``upd + wd * p``).
    ``apply_decay_param_fun(name)`` False exempts a parameter; names
    come from ``(name, parameter)`` pairs in ``parameters``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError(f"lr_ratio is not ported ({_TODO})")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_for(self, i):
        name = self._names[i]
        if self._apply_decay_param_fun is not None and name is not None \
                and not self._apply_decay_param_fun(name):
            return 0.0
        return super()._wd_for(i)

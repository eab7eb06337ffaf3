"""Optimizer base and the zoo: SGD, Momentum, Adam, AdamW, Adamax,
Adagrad, Adadelta, RMSProp, Lamb and LarsMomentum.

Port of ``paddle_tpu/optimizer/optimizer.py``. Each update is the JAX
package's ``_update_leaf``, operation for operation, with its types:
moments in f32 for bf16/fp16 parameters (``_zeros_tree``), and the
learning rate an f32 scalar as the reference's ``Optimizer.step`` passes
it into its jitted update (``jnp.asarray(lr, float32)``): where lr meets
a bf16 gradient the product is f32, where a Python constant meets it the
product stays bf16, and the new value is rounded to the parameter's type
once, at the end.

``Adam`` and ``AdamW`` (``upd = mhat / (sqrt(vhat) + eps)``, plus ``wd *
p`` for AdamW or ``g + wd * p`` for Adam, then ``p - lr * upd``, kept in
an f32 master with ``multi_precision``) step every live parameter in one
call of ``ops.kernels.multi_tensor_adam``: on the card one multi-tensor
kernel, the counterpart of the reference's fused step
(``_get_fused_step``), the global-norm clip fused in; on the CPU its
plain version, the per-leaf update. ``torch.optim.AdamW`` is not used:
it decays the parameter before the Adam step, a different rounding of a
different order.

The learning rate is a number or an ``optimizer.lr.LRScheduler``
(``get_lr()`` reads ``scheduler()``; the caller steps the scheduler).
``grad_clip`` (``nn.ClipGradBy*``) clips the live gradients inside the
step through its own ``clip_values``. The JAX package's optimizer is
functional (new parameters and state out of every update); this one
updates the parameters and its state in place, under ``torch.no_grad``,
and keeps the state by parameter index as the JAX object API does
(``state_dict()["state"]["m"]["0"]``).

``functional()`` is the counterpart of the reference's functional
facade, which ``hapi.Model`` trains through: state keyed as the caller's
parameter dict (by name), the caller's step count and learning rate,
every parameter decayed by ``weight_decay`` unless a ``wd_mask`` says
otherwise, no gradient clip, and the rate weakly typed, as a Python
scalar meets a low-precision tensor in the reference's update
(``optimizer.py:191-227``; ROADMAP Queue 3). It updates the given
tensors in place, Adam and AdamW in one ``multi_tensor_adam`` call.
"""
import numbers

import torch

from ..nn.clip import ClipGradByGlobalNorm
from ..ops.kernels.multi_tensor_adam import (adam_leaf, bias_correction,
                                             multi_tensor_adam, sqrt_rn)
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum"]

_LOW = (torch.float16, torch.bfloat16)


def _moment_dtype(p):
    # moments live in f32 even for fp16/bf16 parameters: fp16 moments
    # flush v ~ g^2 < 6e-8 to zero and mhat / (sqrt(0) + eps) explodes
    return torch.float32 if p.dtype in _LOW else p.dtype


def _zeros(params):
    """``_zeros_tree``: zeros of each parameter's shape, f32 for
    low-precision parameters."""
    return {k: torch.zeros_like(p, dtype=_moment_dtype(p))
            for k, p in params.items()}


def _wide(t):
    """``t`` as the reference's strong-f32 learning rate promotes it: f32
    for a low-precision tensor, unchanged otherwise."""
    return t.float() if t.dtype in _LOW else t


def _c(x, t):
    """The Python constant ``x`` as it meets the tensor ``t`` in the
    reference: a weakly typed constant takes a low-precision tensor's
    type (``0.1 * bf16`` multiplies by bf16(0.1)); torch would keep it in
    f32."""
    return float(torch.tensor(x, dtype=t.dtype)) if t.dtype in _LOW else x


def _decay(g, p, wd):
    """``g + wd * p`` in the parameter's type, when ``wd`` is set."""
    return g + _c(wd, p) * p if wd else g


def _norm(t):
    """``jnp.linalg.norm`` of an f32 tensor: sqrt of the sum of squares."""
    return sqrt_rn(t.square().sum())


class Optimizer:
    """``parameters``: an iterable of ``nn.Parameter``, or of ``(name,
    parameter)`` pairs (``model.named_parameters()``) so that
    ``apply_decay_param_fun`` can read each parameter's name. A
    parameter with ``requires_grad=False`` is not trained; one whose
    ``.grad`` is None is skipped by a step."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(
                f"learning_rate must be a number or an "
                f"optimizer.lr.LRScheduler, got "
                f"{type(learning_rate).__name__}")
        self._lr = learning_rate
        self._names, self._parameters = [], []
        for item in (parameters if parameters is not None else []):
            name_, p = item if isinstance(item, tuple) else \
                (getattr(item, "name", None), item)
            self._names.append(name_)
            self._parameters.append(p)
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._grad_clip = grad_clip
        self._opt_state = None
        self._step_count = 0
        self._weak_lr = False     # True while functional() updates

    # ------------------------------------------------------------- lr
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
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

    def _lr_mul(self, lr, t):
        """``lr * t`` with the rate an f32 scalar as the reference's
        object API passes it (a low-precision ``t`` widened to f32), or,
        inside ``functional()``'s update, weakly typed as the
        reference's jitted functional update takes it (``lr`` rounded to
        ``t``'s type, the product in that type)."""
        return _c(lr, t) * t if self._weak_lr else lr * _wide(t)

    def _update_leaf(self, g, p, state, lr, step, wd):
        """(new value of p, in f32 where the reference computes it so;
        new state)."""
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
        self._apply(live, self.get_lr())

    def _apply(self, live, lr):
        """The per-leaf update of the ``live`` parameters, the clip
        applied to their gradients first (the reference's fused step)."""
        grads = [self._parameters[i].grad for i in live]
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_values(grads)
        for i, g in zip(live, grads):
            k = str(i)
            p = self._parameters[i]
            leaf = {n: st[k] for n, st in self._opt_state.items()}
            new_p, new_state = self._update_leaf(
                g, p, leaf, lr, self._step_count,
                float(self._wd_for(i) or 0.0))
            p.copy_(new_p)                 # rounds to p's dtype
            for n, v in new_state.items():
                self._opt_state[n][k] = v

    # ---------------------------------------------------- functional facade
    def functional(self):
        """``(init_fn, update_fn)`` over a flat ``{name: tensor}``
        parameter dict, as the reference's ``functional()`` returns them.

        ``init_fn(params)`` is the state ``{state name: {name: tensor}}``.
        ``update_fn(grads, params, state, lr=None, step=1, wd_mask=None)``
        updates ``params`` and ``state`` IN PLACE and returns them: the
        learning rate ``lr`` (``get_lr()`` when None), the 1-based
        ``step`` of the bias corrections, ``weight_decay`` for every
        parameter where ``wd_mask`` (``{name: bool}``) is None or True,
        0 elsewhere. Neither ``grad_clip`` nor the optimizer's own decay
        exemptions (``apply_decay_param_fun``, ``no_weight_decay``) take
        part, and ``lr`` meets a low-precision tensor in its type
        (``_lr_mul``), as in the reference's functional update; with
        ``weak_lr=False`` it is an f32 scalar, as the reference's static
        Executor passes it (``jnp.asarray(lr, float32)``)."""
        def init_fn(params):
            return self.init_state(params)

        @torch.no_grad()
        def update_fn(grads, params, state, lr=None, step=1, wd_mask=None,
                      weak_lr=True):
            lr_ = self.get_lr() if lr is None else lr
            keys = sorted(params)
            wd = float(self._weight_decay or 0.0)
            wds = [wd if wd_mask is None or wd_mask[k] else 0.0
                   for k in keys]
            self._functional_update(keys, grads, params, state, float(lr_),
                                    int(step), wds, weak_lr)
            return params, state

        return init_fn, update_fn

    def _functional_update(self, keys, grads, params, state, lr, step, wds,
                           weak_lr=True):
        """The per-leaf update of ``params[k]`` for every key, in place,
        the rate weakly typed (``_lr_mul``) unless ``weak_lr`` is False."""
        self._weak_lr = weak_lr
        try:
            for k, wd in zip(keys, wds):
                leaf = {n: st[k] for n, st in state.items()}
                new_p, new_state = self._update_leaf(
                    grads[k], params[k], leaf, lr, step, wd)
                params[k].copy_(new_p)             # rounds to p's dtype
                for n, v in new_state.items():
                    state[n][k] = v
        finally:
            self._weak_lr = False

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()``. On a ``static.Variable``
        it records the training spec on the loss's program instead (its
        own program: ``minimize`` may follow the ``program_guard``
        block), and ``Executor.run`` trains the parameters of
        ``append_backward`` (those of ``parameter_list`` when given),
        as the reference's does (``optimizer.py:129-144``)."""
        from ..static.graph import Variable
        if isinstance(loss, Variable):
            from .. import static as st
            prog = loss.block.program if loss.block is not None \
                else st.default_main_program()
            pg = st.append_backward(loss, parameter_list=parameter_list,
                                    no_grad_set=no_grad_set)
            prog._train_spec = (self, loss.name, [p.name for p, _ in pg])
            prog._version += 1
            return [], pg
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        sd = {"step": self._step_count}
        if self._opt_state is not None:
            sd["state"] = self._opt_state
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
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
        if "LR_Scheduler" in sd and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(sd["LR_Scheduler"])


class SGD(Optimizer):
    def _update_leaf(self, g, p, state, lr, step, wd):
        g = _decay(g, p, wd)
        return _wide(p) - self._lr_mul(lr, g), {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, params):
        return {"velocity": _zeros(params)}

    def _update_leaf(self, g, p, state, lr, step, wd):
        g = _decay(g, p, wd)
        v = self._momentum * state["velocity"] + g
        upd = g + self._momentum * v if self._nesterov else v
        return _wide(p) - lr * _wide(upd), {"velocity": v}


class Adam(Optimizer):
    """Adam with L2 weight decay (``g + wd * p``), f32 moments for
    low-precision parameters and, with ``multi_precision``, f32 master
    weights for them (an f32 parameter keeps a 0-size sentinel).
    ``lazy_mode`` is accepted and has no effect, as in the reference
    (which does not store it). On the card every step is one call of the
    multi-tensor kernel; a ``ClipGradByGlobalNorm`` clip is fused into
    it, other clips run before it in plain torch."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._decoupled_wd = False
        self._multi_precision = multi_precision
        self._clip_info = None
        self._fused_cache = {}   # the fused step's tables for the live set

    def init_state(self, params):
        st = {"m": _zeros(params), "v": _zeros(params)}
        if self._multi_precision:
            st["master"] = {
                k: (p.detach().float().clone() if p.dtype != torch.float32
                    else torch.zeros((0,), dtype=torch.float32,
                                     device=p.device))
                for k, p in params.items()}
        return st

    def _bias_correction(self, beta, step):
        return bias_correction(beta, step)

    def _update_leaf(self, g, p, state, lr, step, wd):
        master = state.get("master")
        new_p32, m, v = adam_leaf(
            g, p, state["m"], state["v"], master, lr, self._beta1,
            self._beta2, self._eps, self._bias_correction(self._beta1, step),
            self._bias_correction(self._beta2, step), wd, self._decoupled_wd)
        out = {"m": m, "v": v}
        if master is not None:
            out["master"] = new_p32 if master.numel() else master
        return new_p32, out

    def _apply(self, live, lr):
        """Every live parameter in one ``multi_tensor_adam`` call (the
        kernel on the card, the per-leaf plain version on the CPU). The
        last global-norm clip's [scale, norm] stays on the device in
        ``_clip_info``."""
        grads = [self._parameters[i].grad for i in live]
        clip_norm = None
        if isinstance(self._grad_clip, ClipGradByGlobalNorm):
            clip_norm = self._grad_clip.clip_norm
        elif self._grad_clip is not None:
            grads = self._grad_clip.clip_values(grads)
        st = self._opt_state
        keys = [str(i) for i in live]
        masters = [st["master"][k] for k in keys] if "master" in st \
            else [None] * len(keys)
        self._clip_info = multi_tensor_adam(
            grads, [self._parameters[i] for i in live],
            [st["m"][k] for k in keys], [st["v"][k] for k in keys], masters,
            [float(self._wd_for(i) or 0.0) for i in live], lr=lr,
            beta1=self._beta1, beta2=self._beta2, epsilon=self._eps,
            step=self._step_count, decoupled=self._decoupled_wd,
            clip_norm=clip_norm, cache=self._fused_cache)

    def _functional_update(self, keys, grads, params, state, lr, step, wds,
                           weak_lr=True):
        """Every parameter in one ``multi_tensor_adam`` call, the clip
        off: on the card one kernel launch (the rate meets the f32
        update, so ``weak_lr`` changes nothing)."""
        masters = [state["master"][k] for k in keys] if "master" in state \
            else [None] * len(keys)
        multi_tensor_adam(
            [grads[k] for k in keys], [params[k] for k in keys],
            [state["m"][k] for k in keys], [state["v"][k] for k in keys],
            masters, wds, lr=lr, beta1=self._beta1, beta2=self._beta2,
            epsilon=self._eps, step=step, decoupled=self._decoupled_wd,
            cache=self._fused_cache)


class AdamW(Adam):
    """Adam with decoupled weight decay (``upd + wd * p``).
    ``apply_decay_param_fun(name)`` False exempts a parameter; names
    come from ``(name, parameter)`` pairs in ``parameters``. ``lr_ratio``
    is accepted and has no effect, as in the reference (which does not
    store it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, name=None):
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def _update_leaf(self, g, p, state, lr, step, wd):
        g = _decay(g, p, wd)
        m = self._beta1 * state["m"] + _c(1 - self._beta1, g) * g
        u = torch.maximum(self._beta2 * state["u"], g.abs())
        upd = m / (bias_correction(self._beta1, step) * (u + self._eps))
        return _wide(p) - lr * upd, {"m": m, "u": u}


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, params):
        # f32 accumulator for low-precision parameters (as _zeros)
        return {"moment": {k: torch.full_like(p, self._init_acc,
                                              dtype=_moment_dtype(p))
                           for k, p in params.items()}}

    def _update_leaf(self, g, p, state, lr, step, wd):
        g = _decay(g, p, wd)
        acc = state["moment"] + g.square()
        upd = self._lr_mul(lr, g) / (sqrt_rn(acc) + self._eps)
        return _wide(p) - upd, {"moment": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._rho = rho

    def init_state(self, params):
        return {"avg_sq_grad": _zeros(params),
                "avg_sq_update": _zeros(params)}

    def _update_leaf(self, g, p, state, lr, step, wd):
        g = _decay(g, p, wd)
        asg = self._rho * state["avg_sq_grad"] \
            + _c(1 - self._rho, g) * g.square()
        upd = g * sqrt_rn(state["avg_sq_update"] + self._eps) \
            / sqrt_rn(asg + self._eps)
        asu = self._rho * state["avg_sq_update"] \
            + (1 - self._rho) * upd.square()
        return _wide(p) - lr * _wide(upd), \
            {"avg_sq_grad": asg, "avg_sq_update": asu}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = rho, epsilon
        self._momentum = momentum
        self._centered = centered

    def init_state(self, params):
        st = {"mean_square": _zeros(params), "momentum": _zeros(params)}
        if self._centered:
            st["mean_grad"] = _zeros(params)
        return st

    def _update_leaf(self, g, p, state, lr, step, wd):
        g = _decay(g, p, wd)
        ms = self._rho * state["mean_square"] \
            + _c(1 - self._rho, g) * g.square()
        out = {"mean_square": ms}
        denom = ms
        if self._centered:
            mg = self._rho * state["mean_grad"] + _c(1 - self._rho, g) * g
            denom = ms - mg.square()
            out["mean_grad"] = mg
        mom = self._momentum * state["momentum"] \
            + self._lr_mul(lr, g) / sqrt_rn(denom + self._eps)
        out["momentum"] = mom
        return _wide(p) - mom, out


class Lamb(Optimizer):
    """``exclude_from_weight_decay_fn(parameter)`` True exempts a
    parameter from the decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def _wd_for(self, i):
        if self._exclude_fn is not None \
                and self._exclude_fn(self._parameters[i]):
            return 0.0
        return self._weight_decay

    def _update_leaf(self, g, p, state, lr, step, wd):
        g32, p32 = g.float(), p.float()
        m = self._beta1 * state["m"] + (1 - self._beta1) * g32
        v = self._beta2 * state["v"] + (1 - self._beta2) * g32.square()
        mhat = m / bias_correction(self._beta1, step)
        vhat = v / bias_correction(self._beta2, step)
        r = mhat / (sqrt_rn(vhat) + self._eps) + wd * p32
        p_norm, r_norm = _norm(p32), _norm(r)
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        lr32 = torch.tensor(lr, dtype=torch.float32, device=p.device)
        return p32 - lr32 * trust * r, {"m": m, "v": v}


class LarsMomentum(Optimizer):
    """LARS: momentum SGD at the layer-wise rate ``lr * coeff * ||p|| /
    (||g|| + lars_weight_decay * ||p|| + epsilon)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-9, name=None):
        super().__init__(learning_rate, parameters, 0.0, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon

    def init_state(self, params):
        return {"velocity": _zeros(params)}

    def _update_leaf(self, g, p, state, lr, step, wd):
        g32, p32 = g.float(), p.float()
        p_norm, g_norm = _norm(p32), _norm(g32)
        lr32 = torch.tensor(lr, dtype=torch.float32, device=p.device)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr32 * self._lars_coeff * p_norm
            / (g_norm + self._lars_wd * p_norm + self._eps), lr32)
        v = self._momentum * state["velocity"] \
            + local_lr * (g32 + self._lars_wd * p32)
        return p32 - v, {"velocity": v}

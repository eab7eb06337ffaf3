"""The port's vision model zoo (``paddle_tpu_torch/vision/models.py``,
``models_ext.py``) against the JAX package's, on the CPU.

Every family is built in both packages at a small size (MobileNets and
ShuffleNet at their smallest scales, 10 classes, 28–80 px inputs) under
a constant global initializer, which is fast; the reference then takes
weights and batch-norm statistics drawn from a seeded numpy generator
(``set_state_dict``), and the port the same arrays through
``models.load_jax_params(..., buffers=)``. In eval mode the port's logits
are held to the reference's within ``TOL`` of their largest magnitude.
The reference runs jitted (``jax.jit`` of ``paddle_tpu.jit.
functional_call``): its eager CNN forwards are compile-bound, 30–60 s each
on one core, and the jitted ones 0.5–3 s. MobileNetV2 (``scale=0.25``)
also trains six AdamW steps in both packages, eagerly, as
``tests/test_vision_zoo.py`` trains it, each step from the reference's
state: dropout's masks come from one seed in both, and each step's loss,
gradients, AdamW moments, parameter updates and running statistics are
held to the reference's.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu.jit import functional_call
from paddle_tpu.vision import models as JM
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import (export_optimizer_state,
                                     load_jax_params, load_optimizer_state)
from paddle_tpu_torch.vision import models as TM

TOL = 1e-5            # of the largest |logit|, f32 in both
LOSS_TOL = 1e-5       # absolute and relative, on losses of 0.1-2
LR = 1e-3
GRAD_TOL = 1e-3       # of a gradient's largest |value|, floored at
GRAD_FLOOR = 1e-2     # this share of the model's largest gradient
BIG = 0.1             # of that scale: a gradient whose sign is not noise
UPDATE_TOL = 2e-3 * LR   # a parameter's update where its gradient is BIG
STEP_TOL = 2 * LR     # any update: Adam's most, either way
BUFFER_TOL = 1e-4     # running statistics, of max(1, their largest)
KINK_TOL = 1e-5       # a flipped ReLU6 input from its kink, of the largest
MAX_FLIPS = 8         # flipped ReLU6 inputs a step


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


@contextlib.contextmanager
def constant_init(pkg):
    """Build with every parameter a constant (the draws are replaced
    right after)."""
    init = pkg.nn.initializer
    init.set_global_initializer(init.Constant(0.0), init.Constant(0.0))
    try:
        yield
    finally:
        init.set_global_initializer(None, None)


def random_state(ref, seed):
    """Weights N(0, 1 / fan_in) and batch-norm statistics from ``seed``,
    as ``({name: array}, {name: array})``."""
    rng = np.random.default_rng(seed)
    params = {}
    for n, p in ref.named_parameters():
        fan = max(1, int(np.prod(p.shape[1:])))
        params[n] = rng.standard_normal(p.shape, dtype=np.float32) \
            / np.float32(np.sqrt(fan))
    bufs = {}
    for n, b in ref.named_buffers():
        bufs[n] = (0.1 * rng.standard_normal(b.shape, dtype=np.float32)
                   if n.endswith("_mean")
                   else rng.uniform(0.5, 1.5, b.shape).astype(np.float32))
    return params, bufs


def build_pair(name, kw, seed=0):
    with constant_init(jt):
        ref = getattr(JM, name)(**kw)
    with constant_init(pt):
        port = getattr(TM, name)(**kw)
    params, bufs = random_state(ref, seed)
    ref.set_state_dict({**params, **bufs})
    load_jax_params(port, params, buffers=bufs)
    return ref, port


def ref_eval(ref, x):
    ref.eval()
    params = {n: jnp.asarray(p.numpy()) for n, p in ref.named_parameters()}
    fwd = jax.jit(lambda ps, v: functional_call(ref, ps, v))
    return np.asarray(fwd(params, jnp.asarray(x)))


FAMILIES = [
    ("LeNet", {}, 1, 28),
    ("vgg11", {"batch_norm": True, "num_classes": 10}, 3, 32),
    ("resnet18", {"num_classes": 10}, 3, 32),
    ("resnet50", {"num_classes": 10}, 3, 32),
    ("resnext50_32x4d", {"num_classes": 10}, 3, 32),
    ("alexnet", {"num_classes": 10}, 3, 64),
    ("mobilenet_v1", {"scale": 0.25, "num_classes": 10}, 3, 32),
    ("mobilenet_v2", {"scale": 0.25, "num_classes": 10}, 3, 32),
    ("mobilenet_v3_small", {"scale": 0.25, "num_classes": 10}, 3, 32),
    ("mobilenet_v3_large", {"scale": 0.25, "num_classes": 10}, 3, 32),
    ("squeezenet1_0", {"num_classes": 10}, 3, 64),
    ("squeezenet1_1", {"num_classes": 10}, 3, 32),
    ("densenet121", {"num_classes": 10}, 3, 32),
    ("googlenet", {"num_classes": 10}, 3, 64),
    ("inception_v3", {"num_classes": 10}, 3, 80),
    ("shufflenet_v2_x0_25", {"num_classes": 10}, 3, 32),
]


@pytest.mark.parametrize("name,kw,ch,size", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_eval_logits_match_reference(name, kw, ch, size):
    ref, port = build_pair(name, kw)
    x = np.random.default_rng(1).standard_normal(
        (2, ch, size, size), dtype=np.float32)
    want = ref_eval(ref, x)
    port.eval()
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= TOL * scale, (
        name, float(np.abs(got - want).max()), scale)


def test_parameter_and_buffer_names_are_the_references():
    for name, kw, _, _ in FAMILIES:
        with constant_init(jt):
            ref = getattr(JM, name)(**kw)
        with constant_init(pt):
            port = getattr(TM, name)(**kw)
        assert list(ref.state_dict()) == list(port.state_dict()), name
        assert {n: tuple(p.shape) for n, p in ref.named_parameters()} == \
            {n: tuple(p.shape) for n, p in port.named_parameters()}, name


def _host_state(opt):
    sd = opt.state_dict()
    return {"step": sd["step"],
            "state": {k: {i: np.asarray(a) for i, a in v.items()}
                      for k, v in sd["state"].items()}}


def _kink_sides(model, nn):
    """Forward post-hooks on ``model``'s ReLU6 layers: each call appends
    the side of its kinks each input element fell on (0: at or below 0;
    1: between; 2: at or above 6) to the returned list."""
    sides = []

    def hook(layer, inputs, outputs):
        v = np.asarray(inputs[0].numpy())
        sides.append((v > 0).astype(np.int8) + (v >= 6).astype(np.int8))

    for m in model.sublayers():
        if isinstance(m, nn.ReLU6):
            m.register_forward_post_hook(hook)
    return sides


def _follow_sides(model, sides, flips):
    """Forward post-hooks on ``model``'s ReLU6 layers: each output takes
    the side of the first entry of ``sides`` (another run's, in call
    order), which it takes off the list: its input (bit for bit the
    output where the sides agree), 0 or 6, with the gradient of that
    side; and each element whose own input fell on the other side appends
    its distance from that kink, of the layer's largest |input|, to
    ``flips``."""

    def hook(layer, inputs, outputs):
        v = inputs[0].detach()
        want = torch.from_numpy(sides.pop(0))
        own = (v > 0).to(torch.int8) + (v >= 6).to(torch.int8)
        moved = want != own
        if moved.any():
            kink = torch.where(want + own >= 3, 6.0, 0.0)[moved]
            scale = max(float(v.abs().max()), 1e-30)
            flips.extend(((v[moved] - kink).abs() / scale).tolist())
        return torch.where(want == 1, inputs[0], torch.where(
            want == 0, torch.zeros_like(outputs),
            torch.full_like(outputs, 6.0)))

    for m in model.sublayers():
        if isinstance(m, pt.nn.ReLU6):
            m.register_forward_post_hook(hook)


def test_mobilenet_v2_trains_six_adamw_steps_as_the_reference():
    """Six AdamW steps of MobileNetV2 (``scale=0.25``, 4 classes, the
    reference's own initial weights) on one 4 x 3 x 64 x 64 batch, in
    train mode (batch statistics, ``Dropout(0.2)``). Before each step the
    port takes the reference's parameters, batch-norm statistics and
    AdamW moments, and both draw dropout from one seed. Then, each step:

    - the losses within ``LOSS_TOL``;
    - each gradient within ``GRAD_TOL`` of its tensor's largest |value|,
      floored at ``GRAD_FLOOR`` of the model's largest gradient;
    - the AdamW moments after the step within what those gradient errors
      allow (``m`` moves by (1 - beta1) g, ``v`` by (1 - beta2) g^2);
    - each parameter's update within ``UPDATE_TOL`` where its gradient is
      ``BIG`` of the tensor's scale or more (its direction is then set by
      the gradient, not by rounding), and within ``STEP_TOL`` (Adam's
      largest move, either way) where it is not;
    - the running statistics within ``BUFFER_TOL``.

    Run free, two trajectories part within a step or two whatever the
    port does, so each step starts from the reference's state. The
    tolerances are set by the reference against itself: train-mode batch
    norm over 4 images subtracts means that cancel, and the reference's
    f32 gradients differ from an f64 evaluation of the same step by up to
    9.2e-5 in ``GRAD_TOL``'s measure. A ReLU6 input within rounding of a
    kink can fall on the other side in the port and move a gradient term
    whole, so the port takes the reference's side at each kink
    (``_follow_sides``); every such input must lie within ``KINK_TOL`` of
    its layer's largest |input| from the kink, and at most ``MAX_FLIPS``
    a step."""
    jt.seed(0)
    ref = JM.mobilenet_v2(num_classes=4, scale=0.25)
    with constant_init(pt):
        port = TM.mobilenet_v2(num_classes=4, scale=0.25)
    ref.train()
    port.train()
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 4, size=(4,))
    jopt = jt.optimizer.AdamW(learning_rate=LR, parameters=ref.parameters())
    topt = pt.optimizer.AdamW(learning_rate=LR,
                              parameters=port.parameters())
    b1, b2 = 0.9, 0.999
    jx, jy = jt.to_tensor(x), jt.to_tensor(y)
    tx, ty = torch.tensor(x), torch.tensor(y)
    names = [n for n, _ in ref.named_parameters()]
    sides = _kink_sides(ref, jt.nn)
    flips = []
    _follow_sides(port, sides, flips)
    got, want = [], []
    for step in range(6):
        load_jax_params(port, {n: p.numpy()
                               for n, p in ref.named_parameters()},
                        buffers={n: b.numpy()
                                 for n, b in ref.named_buffers()})
        if step:
            load_optimizer_state(topt, _host_state(jopt))
        before = {n: p.numpy() for n, p in ref.named_parameters()}
        sides.clear()
        flips.clear()
        jt.seed(100 + step)
        pt.seed(100 + step)
        loss = jt.nn.functional.cross_entropy(ref(jx), jy)
        loss.backward()
        want.append(float(loss.numpy()))
        tloss = pt.nn.functional.cross_entropy(port(tx), ty)
        tloss.backward()
        got.append(float(tloss.detach()))
        assert not sides                # one ReLU6 call for each
        assert len(flips) <= MAX_FLIPS, (step, len(flips))
        assert max(flips, default=0.0) <= KINK_TOL, (step, max(flips))
        jg = {n: p.grad.numpy() for n, p in ref.named_parameters()}
        tg = {n: p.grad.detach().numpy() for n, p in port.named_parameters()}
        gmax = max(float(np.abs(g).max()) for g in jg.values())
        scale = {n: max(float(np.abs(g).max()), GRAD_FLOOR * gmax)
                 for n, g in jg.items()}
        for n in names:
            err = np.abs(tg[n] - jg[n]).max() / scale[n]
            assert err <= GRAD_TOL, (step, n, float(err))
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
        js = _host_state(jopt)["state"]
        ts = export_optimizer_state(topt)["state"]
        for i, n in enumerate(names):
            k = str(i)
            dm = np.abs(ts["m"][k] - js["m"][k]).max()
            assert dm <= (1 - b1) * GRAD_TOL * scale[n], (step, n, "m", dm)
            dv = np.abs(ts["v"][k] - js["v"][k]).max()
            assert dv <= (1 - b2) * 2 * GRAD_TOL * scale[n] ** 2 \
                + 1e-6 * np.abs(js["v"][k]).max(), (step, n, "v", dv)
        jp = dict(ref.named_parameters())
        for n, t in port.named_parameters():
            err = np.abs((t.detach().numpy() - before[n])
                         - (jp[n].numpy() - before[n]))
            big = np.abs(jg[n]) >= BIG * scale[n]
            assert err[big].max(initial=0.0) <= UPDATE_TOL, (step, n, "big")
            assert err.max() <= STEP_TOL, (step, n)
        jb = dict(ref.named_buffers())
        for n, b in port.named_buffers():
            want_b = jb[n].numpy()
            err = np.abs(b.numpy() - want_b).max()
            assert err <= BUFFER_TOL * max(1.0, np.abs(want_b).max()), (
                step, n, float(err))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got[-1] < got[0]

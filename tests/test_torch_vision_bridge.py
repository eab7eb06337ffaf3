"""``models.load_jax_params(model, params, buffers=)`` carries a JAX-package
model's batch-norm statistics into the port with its weights.

A ``resnet18`` (10 classes) trained two Momentum steps in ``paddle_tpu``,
in train mode, has moved its running ``_mean`` / ``_variance`` off their
initial values; after the crossing the port's eval-mode logits equal the
reference's within ``TOL`` of their largest magnitude, and with the
initial statistics they do not. A missing, extra or misshapen buffer, or
no buffers at all for a model that has them, raises before anything is
copied (the parameters stay as they were).
"""
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
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.vision import models as TM
from test_torch_vision_models import constant_init

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trained():
    """A reference resnet18 after two Momentum steps, its parameters and
    buffers as arrays, and an eval batch with its reference logits."""
    with constant_init(jt):
        ref = JM.resnet18(num_classes=10)
    rng = np.random.default_rng(0)
    ref.set_state_dict({
        n: rng.standard_normal(p.shape, dtype=np.float32)
        / np.float32(np.sqrt(max(1, int(np.prod(p.shape[1:])))))
        for n, p in ref.named_parameters()})
    ref.train()
    opt = jt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                parameters=ref.parameters())
    x = jt.to_tensor(rng.standard_normal((4, 3, 32, 32), dtype=np.float32))
    y = jt.to_tensor(rng.integers(0, 10, 4))
    for _ in range(2):
        loss = jt.nn.functional.cross_entropy(ref(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    ref.eval()
    params = {n: p.numpy() for n, p in ref.named_parameters()}
    buffers = {n: b.numpy() for n, b in ref.named_buffers()}
    xe = rng.standard_normal((2, 3, 32, 32), dtype=np.float32)
    fwd = jax.jit(lambda ps, v: functional_call(ref, ps, v))
    logits = np.asarray(fwd({n: jnp.asarray(a) for n, a in params.items()},
                            jnp.asarray(xe)))
    return params, buffers, xe, logits


def port_model():
    with constant_init(pt):
        return TM.resnet18(num_classes=10)


def eval_logits(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.tensor(x)).numpy()


def test_buffers_moved_and_cross_with_the_weights(trained):
    params, buffers, x, want = trained
    assert any(np.abs(b).max() > 1e-3 for n, b in buffers.items()
               if n.endswith("_mean"))
    port = load_jax_params(port_model(), params, buffers=buffers)
    for n, b in port.named_buffers():
        np.testing.assert_array_equal(b.numpy(), buffers[n])
    got = eval_logits(port, x)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= TOL * scale
    # the initial statistics would give other logits
    alone = port_model()
    alone.set_state_dict({n: p.detach().clone()
                          for n, p in port.named_parameters()})
    assert np.abs(eval_logits(alone, x) - want).max() > 100 * TOL * scale


@pytest.mark.parametrize("edit", ["missing", "extra", "shape", "none"])
def test_a_wrong_buffer_raises_before_anything_is_copied(trained, edit):
    params, buffers, _, _ = trained
    bad = dict(buffers)
    name = "layer1.0.bn1._mean"
    if edit == "missing":
        del bad[name]
    elif edit == "extra":
        bad["layer9.bn._mean"] = bad[name]
    elif edit == "shape":
        bad[name] = np.zeros(3, np.float32)
    else:
        bad = None              # the weights alone: every buffer missing
    port = port_model()
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    with pytest.raises(ValueError if edit == "shape" else KeyError,
                       match=name if edit != "extra" else "layer9"):
        load_jax_params(port, params, buffers=bad)
    for n, p in port.named_parameters():
        assert torch.equal(p, before[n]), n
    for n, b in port.named_buffers():
        assert torch.equal(b, torch.zeros_like(b) if n.endswith("_mean")
                           else torch.ones_like(b)), n

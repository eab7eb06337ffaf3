"""The port's Llama training step against the JAX package's, on the CPU.

``llama_tiny`` (2 layers, 4 query heads over 2 kv heads, head_dim 16)
is built on the JAX side from a seed and bridged into the port with
``load_jax_params``; the same numpy ids go through both, f32
throughout. On the CPU the port runs the plain versions of K4 and K5
and the JAX package its XLA compositions of the same functions.

- forward logits within 1e-5 of the JAX ``LlamaForCausalLM``;
- loss within 1e-6 and step-1 gradients, name for name, within atol
  1e-5 / rtol 1e-4 of ``jax.value_and_grad`` (two layers of products
  summed in another order by another BLAS);
- three steps of the port's ``train_step_fn`` + ``AdamW`` against
  ``paddle_tpu.jit.train_step_fn`` + ``paddle_tpu.optimizer.AdamW``:
  per-step losses within 1e-5, and the trained parameters
  (``export_params``) within 0.02 lr of each other, with rope on the
  composition and on the kernel's route (its CPU body, one call for q
  and k forward and one backward per layer). Adam divides by
  sqrt(v): at step 1 a parameter moves by about lr * sign(g), so the
  gradients' rounding differences show up as fractions of lr, never as
  more than a small one where no gradient is within rounding of zero;
- AdamW alone on fixed gradients against the JAX ``functional()``
  update, f32 and bf16 parameters (f32 moments), with and without the
  decay mask: f32 within two ulps of the parameter and 1e-5 lr (XLA's
  fused multiply-adds; the cancellation in 1 - beta2 ** step), bf16 bit
  for bit;
- options that are not ported raise ``NotImplementedError`` with a
  ROADMAP pointer (the schedulers, clips, ``lr_ratio``, ``attn_mask``,
  ``soft_label`` and ``reduction`` are ported and held against the
  reference in ``test_torch_lr_and_clip.py``,
  ``test_torch_optimizer_zoo.py`` and
  ``test_torch_functional_options.py``; attention dropout in
  ``test_torch_dropout.py``);
- the projections and the head are ``nn.Linear`` layers under the JAX
  parameter names, and the weight bridge round-trips.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.jit import functional_call
from paddle_tpu.jit import train_step_fn as jax_train_step_fn
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.jit import train_step_fn
from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                     llama_tiny, load_jax_params)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import rope as trope
from paddle_tpu_torch.ops.kernels import rope as trk
from paddle_tpu_torch.optimizer import Adam, AdamW

LR = 1e-3
# f32 AdamW: XLA fuses the update's multiplies and adds on the CPU
# (fused multiply-adds round once, torch rounds each op): two ulps of the
# parameter; and 1 - 0.999 ** step cancels, so a one-ulp difference of
# pow becomes ~1e-5 of the step lr * upd: a hundred-thousandth of lr
F32_ULPS = 2.5e-7
F32_STEP = 1e-5 * LR


@functools.lru_cache(maxsize=1)
def _jax_model():
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    return jm


def _port_model():
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy()
                         for n, p in _jax_model().named_parameters()})
    return tm


def _ids(seed=0, b=2, s=24):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, s)).astype(np.int32)


def _jax_loss(logits, labels):
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    return -jnp.take_along_axis(logp, labels[:, 1:, None], -1).mean()


def test_forward_logits_match_jax():
    jm, tm = _jax_model(), _port_model()
    ids = _ids()
    want = np.asarray(functional_call(jm, jm.raw_params(), jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.shape == (2, 24, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    hidden = tm(ids, return_hidden=True)
    assert hidden.shape == (2, 24, 64)


def test_loss_and_step1_gradients_match_jax():
    jm, tm = _jax_model(), _port_model()
    ids = _ids(1)

    def compute(ps):
        return _jax_loss(functional_call(jm, ps, jnp.asarray(ids)),
                         jnp.asarray(ids))

    jloss, jgrads = jax.value_and_grad(compute)(jm.raw_params())
    loss = tm.loss(tm(ids), torch.from_numpy(ids).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-6)
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(jgrads[n]), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_three_adamw_steps_match_the_jax_train_step():
    _three_adamw_steps_match_the_jax_train_step()


def test_three_adamw_steps_through_the_rope_kernel_route_match_jax(
        monkeypatch):
    """The same steps with rope on the kernel's route as the card takes
    it (``apply_rotary_qk`` -> ``RopeQKFunction``, one call forward and
    one backward per layer), its CPU body the plain version: the losses
    and weights still match the JAX train step."""
    calls = []
    pair = trk.rope_qk_fwd
    monkeypatch.setattr(trope, "_kernel_route",
                        lambda position_ids, *xs: position_ids is None)
    monkeypatch.setattr(trk, "rope_qk_fwd",
                        lambda *a: calls.append(a[-1]) or pair(*a))
    _three_adamw_steps_match_the_jax_train_step()
    layers = llama_tiny().num_layers       # signs: forward, backward
    assert calls == ([1] * layers + [-1] * layers) * 3


def _three_adamw_steps_match_the_jax_train_step():
    jm, tm = _jax_model(), _port_model()
    batches = [_ids(10)] * 3          # one fixed batch, as bench.py

    jopt = pt.optimizer.AdamW(learning_rate=LR,
                              parameters=jm.parameters())
    jstep = jax_train_step_fn(jm, _jax_loss, jopt, donate=False)
    params = jm.raw_params()
    state = jopt.functional()[0](params)
    jlosses = []
    for i, ids in enumerate(batches):
        batch = {"inputs": (jnp.asarray(ids),), "labels": (jnp.asarray(ids),)}
        loss, params, state = jstep(params, state, batch, i + 1)
        jlosses.append(float(loss))

    opt = AdamW(learning_rate=LR, parameters=tm.named_parameters())
    step = train_step_fn(tm, tm.loss, opt)
    losses = [step({"inputs": (torch.from_numpy(ids),),
                    "labels": (torch.from_numpy(ids).long(),)}).item()
              for ids in batches]

    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    assert losses[2] < losses[0]
    got = export_params(tm)
    assert set(got) == set(params)
    for n, a in got.items():
        np.testing.assert_allclose(a, np.asarray(params[n]), rtol=0,
                                   atol=0.02 * LR, err_msg=n)
    assert all(p.grad is None for p in tm.parameters())
    assert opt.state_dict()["step"] == 3


def _step(i):
    # the step as the jitted train step sees it, an int32 array: the bias
    # corrections 1 - beta ** step are then f32 (a Python int step would
    # make them f64, rounded once)
    return jnp.asarray(i, jnp.int32)


def _leaves(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"a": (8, 16), "b": (16,), "c": (4, 4, 4)}
    ps = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: (rng.standard_normal(s) * 10.0 ** -rng.integers(0, 4)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(3)]
    if dtype == "bfloat16":   # round once, identically on both sides
        ps = {k: torch.tensor(v).bfloat16().float().numpy()
              for k, v in ps.items()}
        gs = [{k: torch.tensor(v).bfloat16().float().numpy()
               for k, v in g.items()} for g in gs]
    return ps, gs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_adamw_update_matches_the_jax_functional_update(dtype, masked):
    ps, gs = _leaves(7, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    decay = {"a": True, "b": not masked, "c": True}

    jopt = pt.optimizer.AdamW(learning_rate=LR, weight_decay=0.1)
    init_fn, update_fn = jopt.functional()
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in ps.items()}
    jstate = init_fn(jp)
    for i, g in enumerate(gs):
        jg = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        jp, jstate = update_fn(jg, jp, jstate, step=_step(i + 1),
                               wd_mask=decay)

    tp = {k: torch.nn.Parameter(torch.tensor(v).to(tdt))
          for k, v in ps.items()}
    opt = AdamW(learning_rate=LR, weight_decay=0.1,
                parameters=list(tp.items()),
                apply_decay_param_fun=lambda n: decay[n])
    for g in gs:
        for k, p in tp.items():
            p.grad = torch.tensor(g[k]).to(tdt)
        opt.step()
        opt.clear_grad()
    for k, p in tp.items():
        assert p.dtype == tdt
        want = np.asarray(jp[k].astype(jnp.float32))
        got = p.detach().float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=F32_ULPS,
                                       atol=F32_STEP, err_msg=k)
        m = opt.state_dict()["state"]["m"][str(list(tp).index(k))]
        assert m.dtype == torch.float32
        np.testing.assert_allclose(
            m.numpy(), np.asarray(jstate["m"][k]), rtol=1e-6, atol=1e-9)


def test_adam_l2_and_multi_precision_match_jax():
    ps, gs = _leaves(8, "bfloat16")
    jopt = pt.optimizer.Adam(learning_rate=LR, weight_decay=0.05,
                             multi_precision=True)
    init_fn, update_fn = jopt.functional()
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in ps.items()}
    jstate = init_fn(jp)
    for i, g in enumerate(gs):
        jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
        jp, jstate = update_fn(jg, jp, jstate, step=_step(i + 1))
    tp = [torch.nn.Parameter(torch.tensor(v).bfloat16()) for v in ps.values()]
    opt = Adam(learning_rate=LR, weight_decay=0.05, parameters=tp,
               multi_precision=True)
    for g in gs:
        for p, v in zip(tp, g.values()):
            p.grad = torch.tensor(v).bfloat16()
        opt.step()
    for i, (k, p) in enumerate(zip(ps, tp)):
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(jp[k].astype(jnp.float32)))
        np.testing.assert_allclose(
            opt.state_dict()["state"]["master"][str(i)].numpy(),
            np.asarray(jstate["master"][k]), rtol=F32_ULPS, atol=F32_STEP)
    sd = opt.state_dict()
    fresh = Adam(learning_rate=LR, parameters=tp, multi_precision=True)
    with pytest.raises(ValueError, match="master"):
        fresh.set_state_dict({"step": 3, "state": {"m": sd["state"]["m"],
                                                   "v": sd["state"]["v"]}})
    fresh.set_state_dict(sd)
    assert fresh.state_dict()["step"] == 3
    fresh.set_lr(5e-4)
    assert fresh.get_lr() == 5e-4


@pytest.mark.parametrize("what", ["pipeline_decompose",
                                  "tensor_parallel"])
def test_unported_options_raise_with_a_roadmap_pointer(what):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "pipeline_decompose":
            _port_model().pipeline_decompose()
        else:
            LlamaForCausalLM(llama_tiny(tensor_parallel=True), device="cpu")


def test_projections_are_linear_layers_under_the_jax_names():
    """The seven projections of every block and the head are ``nn.Linear``
    without a bias: the parameter names stay the JAX module's, so the
    bridge round-trips and the optimizer sees the same names."""
    jm, tm = _jax_model(), _port_model()
    blk = tm.model.layers[0]
    layers = [tm.lm_head, blk.self_attn.q_proj, blk.self_attn.k_proj,
              blk.self_attn.v_proj, blk.self_attn.o_proj, blk.mlp.gate_proj,
              blk.mlp.up_proj, blk.mlp.down_proj]
    assert all(isinstance(m, Linear) and m.bias is None for m in layers)
    assert blk.self_attn.q_proj.weight.shape == (64, 64)
    assert blk.mlp.down_proj.weight.shape == (128, 64)
    want = {n: p.numpy() for n, p in jm.named_parameters()}
    got = export_params(tm)
    assert list(got) == [n for n, _ in tm.named_parameters()]
    assert set(got) == set(want)
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a)
    again = LlamaForCausalLM(llama_tiny(), device="cpu", seed=9)
    load_jax_params(again, got)
    assert all(np.array_equal(export_params(again)[n], a)
               for n, a in want.items())


def test_linear_defaults_to_the_card_and_llama_draws_its_own_weights():
    """``nn.Linear`` resolves ``device=None`` to the card like every other
    entry point (so it raises on a machine without one), and building a
    Llama draws each projection once, from its own generator: the global
    RNG is left as it was."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Linear(4, 3)
    lin = Linear(4, 3, device="cpu")
    assert lin.weight.device.type == "cpu" and lin.weight.shape == (4, 3)
    assert torch.equal(lin.bias, torch.zeros(3))
    torch.manual_seed(0)
    before = torch.rand(4)
    torch.manual_seed(0)
    LlamaForCausalLM(llama_tiny(), device="cpu", seed=1)
    assert torch.equal(torch.rand(4), before)


@pytest.mark.parametrize("args,kwargs", [
    ((), {}), ((None, False), {}), ((None, None), {}),
    ((None, False, "fc"), {}), ((), {"bias_attr": False}),
    ((), {"weight_attr": None, "bias_attr": None, "name": "fc"})])
def test_linear_takes_the_reference_arguments(args, kwargs):
    """``Linear(in, out, weight_attr, bias_attr, name)`` in the
    reference's order: the same positional and keyword arguments build
    the same parameter shapes, with or without a bias."""
    ref = pt.nn.Linear(6, 5, *args, **kwargs)
    got = Linear(6, 5, *args, **kwargs, device="cpu")
    assert tuple(got.weight.shape) == tuple(ref.weight.shape) == (6, 5)
    assert (got.bias is None) == (ref.bias is None)
    if got.bias is not None:
        assert tuple(got.bias.shape) == tuple(ref.bias.shape) == (5,)


def test_linear_refuses_a_parameter_attribute_it_cannot_honour():
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        Linear(6, 5, pt.ParamAttr(name="w"), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        Linear(6, 5, bias_attr=pt.ParamAttr(name="b"), device="cpu")


def test_cross_entropy_ignores_the_ignore_index():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 7))
                              .astype(np.float32))
    labels = torch.tensor([[1, -100, 3, 0, 6], [-100, -100, 2, 2, 5]])
    keep = labels != -100
    logp = torch.log_softmax(logits, -1)
    want = -logp[keep].gather(-1, labels[keep][:, None]).sum() / keep.sum()
    got = F.cross_entropy(logits, labels)
    np.testing.assert_allclose(got.item(), want.item(), rtol=0, atol=1e-6)

"""The port's automatic mixed precision against the JAX package's, on the
CPU.

- ``cast_inputs_for_op`` casts each op's inputs as the reference's does
  (white list to the AMP dtype, black list to f32, floating tensors of
  one dimension or more only), and the functional entry points the
  Llama train step reaches (``linear``, attention with and without a
  mask, ``rms_norm``, ``softmax``, ``cross_entropy`` hard and soft, and
  ``silu`` on neither list) give the reference's output dtypes under O1,
  their values within bf16 rounding (2^-7 of the largest value);
- ``decorate`` casts parameters only: the Llama rope tables stay f32, as
  the reference's ``Layer.astype`` leaves its buffers;
- ``GradScaler``: a step with an inf gradient is skipped with the
  parameters unchanged bit for bit, the scale backs off after
  ``decr_every_n_nan_or_inf`` bad steps and grows after
  ``incr_every_n_steps`` good ones, the parameters after every step and
  the state dict equal to the reference's; ``unscale_`` twice before a
  step divides once; bf16 gradients under a scale that is not a power of
  two are unscaled by the inverse rounded to bf16, as the reference's
  ``_fused_unscale`` does;
- ``llama_tiny``'s loss under ``auto_cast`` O1 (f32 parameters) and O2
  (``decorate``d to bf16) against the JAX model's under its auto_cast,
  within 2e-2 (bf16 projections and attention, summed in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core.tensor import Parameter, wrap
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.nn import functional as F

OPS = ["linear", "flash_attention", "sdp_attention", "rms_norm", "softmax",
       "cross_entropy_with_softmax", "cross_entropy_soft", "silu",
       "embedding", "matmul"]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", OPS)
def test_cast_rule_matches_the_reference(op, level):
    vals = [np.ones((2, 3), np.float32), np.ones((2, 3), np.float32),
            np.ones((3,), np.int32), np.float32(2.0)]
    jv = [jnp.asarray(vals[0]), jnp.asarray(vals[1]).astype(jnp.bfloat16),
          jnp.asarray(vals[2]), jnp.asarray(vals[3])]
    tv = [torch.tensor(vals[0]), torch.tensor(vals[1]).bfloat16(),
          torch.tensor(vals[2]), torch.tensor(vals[3]), None]
    with pt.amp.auto_cast(level=level, dtype="bfloat16"):
        want = pt.amp.cast_inputs_for_op(op, jv, pt.amp.amp_state())
    with amp.auto_cast(level=level, dtype="bfloat16"):
        got = amp.cast_inputs_for_op(op, tv)
    assert got[-1] is None
    assert [str(t.dtype).replace("torch.", "") for t in got[:-1]] == \
        [str(v.dtype) for v in want]
    assert amp.cast_inputs_for_op(op, tv) is tv        # AMP off
    with amp.auto_cast(custom_black_list={op}):
        assert amp.cast_inputs_for_op(op, tv)[1].dtype == torch.float32


def _rng_f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _entry(which, lib, T):
    """One functional entry point of ``lib`` (either package) on inputs
    wrapped by ``T``."""
    x = T(_rng_f32((2, 8, 16), 1))
    if which == "linear":
        return lib.linear(x, T(_rng_f32((16, 12), 2)), T(_rng_f32((12,), 3)))
    if which in ("sdpa", "sdpa_mask"):
        q, k, v = (T(_rng_f32((2, 8, 2, 16), s)) for s in (4, 5, 6))
        mask = T(_rng_f32((8, 8), 7)) if which == "sdpa_mask" else None
        return lib.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                is_causal=True)
    if which == "rms_norm":
        return lib.rms_norm(T(_rng_f32((4, 16), 8), "bfloat16"),
                            T(_rng_f32((16,), 9), "bfloat16"), 1e-5)
    if which == "softmax":
        return lib.softmax(T(_rng_f32((4, 16), 8), "bfloat16"))
    if which == "silu":
        return lib.silu(T(_rng_f32((4, 16), 8), "bfloat16"))
    if which == "cross_entropy":
        lab = np.random.default_rng(3).integers(0, 16, (4,))
        return lib.cross_entropy(T(_rng_f32((4, 16), 8), "bfloat16"),
                                 T(lab, "int64"))
    soft = np.random.default_rng(4).dirichlet(np.ones(16), 4).astype(
        np.float32)
    return lib.cross_entropy(T(_rng_f32((4, 16), 8), "bfloat16"),
                             T(soft, "bfloat16"), soft_label=True)


def _jt(a, dtype="float32"):
    return pt.to_tensor(jnp.asarray(a).astype(getattr(jnp, dtype)))


def _tt(a, dtype="float32"):
    return torch.tensor(np.asarray(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("which", ["linear", "sdpa", "sdpa_mask", "rms_norm",
                                   "softmax", "silu", "cross_entropy",
                                   "cross_entropy_soft"])
def test_entry_points_cast_as_the_reference_under_o1(which):
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        want = _entry(which, pt.nn.functional, _jt)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = _entry(which, F, _tt)
    w = np.asarray(want._value.astype(jnp.float32))
    assert str(got.dtype).replace("torch.", "") == str(want._value.dtype)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=2 ** -7 * np.abs(w).max())


def _jax_model(seed=21):
    pt.seed(seed)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    return jm


def test_decorate_casts_parameters_and_leaves_the_rope_tables():
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    opt = topt.AdamW(parameters=tm.named_parameters())
    params = list(tm.parameters())
    m, o = amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert m is tm and o is opt and tm.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(a is b for a, b in zip(params, tm.parameters()))
    attn = tm.model.layers[0].self_attn
    assert attn.rope_cos.dtype == attn.rope_sin.dtype == torch.float32
    jm = _jax_model()
    pt.amp.decorate(jm, level="O2", dtype="bfloat16")
    jattn = jm.model.layers[0].self_attn
    assert jattn.q_proj.weight.dtype == jnp.bfloat16
    assert jattn.rope_cos._value.dtype == jnp.float32


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_llama_tiny_loss_under_auto_cast_matches_jax(level):
    jm = _jax_model()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    if level == "O2":
        pt.amp.decorate(jm, level="O2", dtype="bfloat16")
        amp.decorate(tm, level="O2", dtype="bfloat16")
    ids = np.random.default_rng(12).integers(0, 256, (2, 24)).astype(
        np.int32)
    with pt.amp.auto_cast(level=level, dtype="bfloat16"):
        jids = pt.to_tensor(ids)
        want = float(jm.loss(jm(jids), jids)._value)
    with amp.auto_cast(level=level, dtype="bfloat16"):
        t = torch.from_numpy(ids).long()
        logits = tm(t)
        got = tm.loss(logits, t)
    assert logits.dtype == torch.bfloat16 and got.dtype == torch.float32
    got.backward()
    assert all(p.grad is not None and p.grad.dtype == p.dtype
               for p in tm.parameters())
    with torch.no_grad():
        plain = tm.loss(tm(t), t).item()
    if level == "O1":          # the casts took effect
        assert got.item() != plain
    np.testing.assert_allclose(got.item(), want, rtol=0, atol=2e-2)


def _scaler_run(mod, opt_cls, P, grad_of, set_grad, to_np, inject):
    """Five steps of a GradScaler (growth every 2 good steps, backoff
    after one bad step) over one parameter, an inf gradient injected at
    the steps in ``inject``. Returns (scales, params, state dict)."""
    w = P(np.linspace(-1, 1, 6).astype(np.float32))
    opt = opt_cls(learning_rate=0.1, parameters=[w])
    scaler = mod.GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
                            decr_every_n_nan_or_inf=1)
    scales, params = [], []
    for step in range(5):
        loss = grad_of(w, step)
        scaler.scale(loss).backward()
        if step in inject:
            set_grad(w)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(scaler.get_init_loss_scaling())
        params.append(to_np(w))
    return scales, params, scaler.state_dict()


def test_grad_scaler_matches_the_reference():
    x = np.arange(1, 7, dtype=np.float32)

    def jgrad(w, step):
        return (w * pt.to_tensor(x * (step + 1))).sum()

    def jinf(w):
        w.grad = wrap(w.grad._value.at[0].set(jnp.inf))

    def tgrad(w, step):
        return (w * torch.from_numpy(x * (step + 1))).sum()

    def tinf(w):
        w.grad[0] = float("inf")

    with jax.disable_jit():       # op by op, as the port rounds
        want = _scaler_run(pt.amp, pt.optimizer.SGD,
                           lambda a: Parameter(jnp.asarray(a)), jgrad, jinf,
                           lambda w: np.asarray(w._value).copy(), {2})
    got = _scaler_run(amp, topt.SGD, lambda a: torch.nn.Parameter(
        torch.from_numpy(a)), tgrad, tinf, lambda w: w.detach().numpy().copy(),
        {2})
    assert got[0] == want[0] == [1024.0, 2048.0, 1024.0, 1024.0, 2048.0]
    np.testing.assert_array_equal(got[1][2], got[1][1])   # skipped step
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


def test_unscale_twice_divides_once_and_rounds_the_inverse_to_bf16():
    g = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    w = torch.nn.Parameter(torch.zeros(64, dtype=torch.bfloat16))
    w.grad = torch.from_numpy(g).bfloat16()
    opt = topt.SGD(learning_rate=0.1, parameters=[w])
    scaler = amp.GradScaler(init_loss_scaling=1000.0)
    scaler.unscale_(opt)
    once = w.grad.clone()
    scaler.unscale_(opt)
    assert torch.equal(w.grad, once)
    unscaled, finite = pt.amp._fused_unscale(
        (jnp.asarray(g).astype(jnp.bfloat16),),
        jnp.asarray(1.0 / 1000.0, jnp.float32))
    np.testing.assert_array_equal(
        once.float().numpy(), np.asarray(unscaled[0].astype(jnp.float32)))
    assert bool(finite) and not scaler._found_inf
    sd = scaler.state_dict()
    again = amp.GradScaler()
    again.load_state_dict(sd)
    assert again.get_init_loss_scaling() == 1000.0

"""The port's int8 path (K8, ``quantization``) against the JAX package's,
on the CPU.

The same numpy inputs (seeded) go through the JAX functions and the
port's plain versions, which the CUDA kernel is held to bit for bit on
the card (``chip_smoke.py`` phase ``k8``):

- ``quantize_tensor``: codes and scales bit for bit, f32 and bf16, per
  tensor and per channel (the scale stays in x's dtype);
- ``quantized_matmul`` fed the JAX quantizer's own codes and scales, bit
  for bit against the JAX function at a divisible shape (the Pallas
  kernel in interpret mode) and a ragged one (its XLA path): both sum
  exactly and dequantize as ``acc * sx * sw`` in that order;
- a per-row x scale raises (ROADMAP, Queue 3);
- ``to_int8_inference`` on ``llama_tiny`` (weights bridged from the JAX
  model) against the JAX ``to_int8_inference``: every converted layer's
  int8 codes and scales bit for bit, logits within one quantisation step
  of the head (the head's input scale times its largest weight scale
  times 127: what one flipped input code can move a logit), greedy
  argmax equal, the original left untouched with ``inplace=False``;
- ``Int8InferLinear`` with a bias, and the paged serving bundle refusing
  a converted model (ROADMAP, Queue 1 item 10).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu.quantization import to_int8_inference as jax_to_int8
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm
from paddle_tpu_torch.quantization import (Int8InferLinear,
                                           to_int8_inference)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    a = jnp.asarray(a)
    return np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                    else a)


def _t2np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_tensor_matches_jax_bit_for_bit(dtype, axis):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((32, 48)) * rng.uniform(0.1, 3, (1, 48))) \
        .astype(np.float32)
    x[3, 5] = 0.0
    jq, js = jqm.quantize_tensor(jnp.asarray(x).astype(jdt),
                                 per_channel_axis=axis)
    q, s = tqm.quantize_tensor(torch.from_numpy(x).to(tdt),
                               per_channel_axis=axis)
    assert q.dtype == torch.int8 and s.dtype == tdt
    assert tuple(s.shape) == tuple(js.shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_t2np(s), _np(js))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(128, 256, 128), (37, 100, 50)],
                         ids=["divisible", "ragged"])
def test_quantized_matmul_matches_jax_bit_for_bit(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    m, k, n = shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jx, sx = jqm.quantize_tensor(jnp.asarray(x).astype(jdt))
    jw, sw = jqm.quantize_tensor(jnp.asarray(w).astype(jdt),
                                 per_channel_axis=1)
    want = np.asarray(jqm.quantized_matmul(jx, jw, sx, sw, block_m=128,
                                           block_n=128, block_k=128,
                                           interpret=True))
    got = tqm.quantized_matmul(
        torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jw)),
        torch.from_numpy(_np(sx)).to(tdt), torch.from_numpy(_np(sw)).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tqm.quantized_matmul.launches == 0   # CPU: the plain version
    bf = tqm.quantized_matmul(torch.from_numpy(np.array(jx)),
                              torch.from_numpy(np.array(jw)),
                              torch.from_numpy(_np(sx)),
                              torch.from_numpy(_np(sw)),
                              out_dtype=torch.bfloat16)
    assert torch.equal(bf, got.to(torch.bfloat16))


def test_a_per_row_x_scale_raises():
    x = torch.ones(4, 8, dtype=torch.int8)
    w = torch.ones(8, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="scalar"):
        tqm.quantized_matmul(x, w, torch.ones(4), torch.ones(3))
    with pytest.raises(ValueError, match="scale_w"):
        tqm.quantized_matmul(x, w, 1.0, torch.ones(4))


@functools.lru_cache(maxsize=1)
def _llamas():
    """The JAX llama_tiny, its int8 conversion and the JAX int8 logits;
    the port's model from the same weights."""
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    jq = jax_to_int8(jm)
    ids = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(np.int32)
    return jq, tm, ids, np.asarray(jq(pt.to_tensor(ids)).numpy())


def test_to_int8_inference_matches_the_jax_conversion():
    jq, tm, ids, want = _llamas()
    with torch.no_grad():
        before = tm(torch.from_numpy(ids))
    q = to_int8_inference(tm)                  # inplace=False: a copy
    names = [n for n, m in q.named_modules() if isinstance(m, Int8InferLinear)]
    assert len(names) == 7 * tm.cfg.num_layers + 1 and "lm_head" in names
    assert not any(isinstance(m, Linear) for m in q.modules())
    jmods = dict(jq.named_sublayers())
    for n in names:
        np.testing.assert_array_equal(q.get_submodule(n).qweight.numpy(),
                                      np.asarray(jmods[n].qweight.numpy()))
        np.testing.assert_array_equal(q.get_submodule(n).w_scale.numpy(),
                                      np.asarray(jmods[n].w_scale.numpy()))
    with torch.no_grad():
        got = q(torch.from_numpy(ids))
        h = q(torch.from_numpy(ids), return_hidden=True)
    _, sx = tqm.quantize_tensor(h.reshape(-1, h.shape[-1]))
    step = (sx * q.lm_head.w_scale.max() * 127).item()
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=step)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    assert not got.requires_grad
    # the original is untouched
    assert all(isinstance(m, Linear) for m in
               (tm.lm_head, tm.model.layers[0].mlp.down_proj))
    with torch.no_grad():
        assert torch.equal(tm(torch.from_numpy(ids)), before)


def test_int8_linear_with_a_bias_and_in_place_conversion():
    pt.seed(3)
    jnet = pt.nn.Sequential(pt.nn.Linear(16, 24), pt.nn.Linear(24, 8))
    tnet = torch.nn.Sequential(Linear(16, 24, device="cpu"),
                               Linear(24, 8, device="cpu"))
    for jl, tl in zip(jnet, tnet):
        with torch.no_grad():
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight.numpy())))
            tl.bias.copy_(torch.from_numpy(
                np.random.default_rng(4).standard_normal(tl.bias.shape)
                .astype(np.float32)))
        jl.bias.set_value(tl.bias.detach().numpy())
    x = np.random.default_rng(5).standard_normal((5, 16)).astype(np.float32)
    want = np.asarray(jax_to_int8(jnet)(pt.to_tensor(x)).numpy())
    out = to_int8_inference(tnet, inplace=True)
    assert out is tnet and isinstance(tnet[1], Int8InferLinear)
    assert tnet[1].bias is not None
    got = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_serving_a_converted_model_raises_with_a_roadmap_pointer():
    _, tm, _, _ = _llamas()
    q = to_int8_inference(tm)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        q._decode_bundle(32, cache_backend="paged", page_size=8,
                         num_pages=9)

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
  a converted model, as the reference refuses it;
- the K-major entry (``quantized_matmul_kmajor``, the weight ``[N, K]``
  as the kernel reads it) against the reference layout's entry and the
  JAX function, bit for bit, f32 and bf16 out; the kernel route each of
  ``chip_smoke.py``'s K8 cases takes, picked before any launch; the
  converted layer's one K-major int8 buffer, its ``qweight`` view and
  its forward in x's dtype (one rounding, as f32 then cast).
"""
import functools
import importlib.util
import pathlib

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
    """The reference refuses a converted model too (its bundles read
    trainable parameters only), and the message says so."""
    _, tm, _, _ = _llamas()
    q = to_int8_inference(tm)
    with pytest.raises(NotImplementedError, match="as in the reference"):
        q._decode_bundle(32, cache_backend="paged", page_size=8,
                         num_pages=9)


# ------------------------------------------------- the K-major weight


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("shape", [(128, 256, 128), (37, 100, 50)],
                         ids=["divisible", "ragged"])
def test_kmajor_entry_matches_the_reference_layout_and_jax(shape, out):
    jdt, tdt = DTYPES[out]
    m, k, n = shape
    rng = np.random.default_rng(11)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jx, sx = jqm.quantize_tensor(jnp.asarray(x))
    jw, sw = jqm.quantize_tensor(jnp.asarray(w), per_channel_axis=1)
    want = jqm.quantized_matmul(jx, jw, sx, sw, block_m=128, block_n=128,
                                block_k=128, interpret=True, out_dtype=jdt)
    tx, tw = torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jw))
    tsx, tsw = torch.from_numpy(_np(sx)), torch.from_numpy(_np(sw))
    got = tqm.quantized_matmul_kmajor(tx, tw.t().contiguous(), tsx, tsw,
                                      out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (m, n)
    assert torch.equal(got, tqm.quantized_matmul(tx, tw, tsx, tsw,
                                                 out_dtype=tdt))
    np.testing.assert_array_equal(_t2np(got), _np(want))
    assert tqm.quantized_matmul.launches == 0   # CPU: the plain version


def _chip_smoke_k8_cases():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K8_CASES


def test_route_is_picked_from_the_shape_before_any_launch():
    """wgmma where K is a multiple of 16, N of 8 and every pointer
    16-byte aligned (every 7B case, the decode batch, ragged M and the
    tile's tails);
    mma.sync for the rest; a shape neither takes raises."""
    want = {"7b-qkvo": "wgmma", "7b-gate-up": "wgmma", "7b-down": "wgmma",
            "7b-head": "wgmma", "decode": "wgmma", "ragged-m": "wgmma",
            "tails": "wgmma", "ragged-all": "mma_sync"}
    cases = _chip_smoke_k8_cases()
    assert {c[0] for c in cases} == set(want)
    for tag, m, k, n in cases:
        assert tqm.route(m, n, k, aligned=True) == want[tag], tag
    assert tqm.route(4096, 11008, 4096, aligned=False) == "mma_sync"
    assert tqm.route(8, 8, 0, aligned=True) == "mma_sync"
    with pytest.raises(ValueError, match="mma.sync"):
        tqm.route(tqm.MAX_MMA_ROWS + 1, 1002, 1000, aligned=True)
    with pytest.raises(ValueError, match="exact"):
        tqm.route(8, 8, tqm.MAX_K, aligned=True)
    assert tqm.quantized_matmul.launches == 0


def test_converted_model_holds_one_kmajor_int8_buffer_a_layer():
    jq, tm, _, _ = _llamas()
    q = to_int8_inference(tm)
    jmods = dict(jq.named_sublayers())
    int8 = {n: b for n, b in q.named_buffers() if b.dtype == torch.int8}
    layers = {n: m for n, m in q.named_modules()
              if isinstance(m, Int8InferLinear)}
    assert set(int8) == {f"{n}.qweight_t" for n in layers}
    total = 0
    for n, mod in layers.items():
        k, n_out = tm.get_submodule(n).weight.shape
        assert mod.qweight_t.shape == (n_out, k)
        assert mod.qweight_t.is_contiguous()
        # the reference's [in, out] codes: a view, no second buffer
        assert mod.qweight.shape == (k, n_out)
        assert mod.qweight.data_ptr() == mod.qweight_t.data_ptr()
        np.testing.assert_array_equal(mod.qweight.numpy(),
                                      np.asarray(jmods[n].qweight.numpy()))
        total += k * n_out
    assert sum(b.numel() * b.element_size() for b in int8.values()) == total


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_forward_in_x_dtype_rounds_once(dtype):
    """The layer asks K8 for x's dtype: equal, bit for bit, to the f32
    result cast to x's dtype (the reference's order)."""
    _, tdt = DTYPES[dtype]
    rng = np.random.default_rng(12)
    lin = Linear(64, 48, bias_attr=False, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(
            rng.standard_normal((64, 48)).astype(np.float32)))
    layer = Int8InferLinear(lin.to(tdt))
    x = torch.from_numpy(
        rng.standard_normal((5, 7, 64)).astype(np.float32)).to(tdt)
    got = layer(x)
    qx, sx = tqm.quantize_tensor(x.reshape(-1, 64))
    f32 = tqm._ref(qx, layer.qweight, sx, layer.w_scale)
    assert got.dtype == tdt
    assert torch.equal(got, f32.to(tdt).reshape(5, 7, 48))


def test_int8_state_dict_is_the_references_and_loads_from_it():
    """The converted model's state dict has the reference's keys and
    shapes (``qweight [in, out]``, not the K-major buffer), and the
    reference's int8 state dict loaded into another converted model
    gives the converted model's forward bit for bit, the K-major buffer
    kept (ROADMAP Queue 3)."""
    jq, tm, ids, _ = _llamas()
    q = to_int8_inference(tm)
    want = {k: tuple(v.shape) for k, v in jq.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in q.state_dict().items()}
    assert got == want
    assert not any(k.endswith("qweight_t") for k in got)
    jsd = {k: torch.tensor(np.asarray(v.numpy()))
           for k, v in jq.state_dict().items()}
    other = to_int8_inference(LlamaForCausalLM(llama_tiny(), device="cpu",
                                               seed=7))
    x = torch.from_numpy(ids)
    with torch.no_grad():
        assert not torch.equal(other(x), q(x))
        missing, unexpected = other.load_state_dict(jsd)
        assert not missing and not unexpected
        assert torch.equal(other(x), q(x))
    mod = other.lm_head
    assert mod.qweight_t.is_contiguous()
    assert mod.qweight_t.shape == (mod.w_scale.shape[0],
                                   q.lm_head.qweight.shape[0])
    np.testing.assert_array_equal(mod.qweight.numpy(),
                                  np.asarray(dict(jq.named_sublayers())
                                             ["lm_head"].qweight.numpy()))

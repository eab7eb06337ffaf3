"""The port's deployment archives against the JAX package's, on the CPU.

Counterparts of ``tests/test_deploy_decode.py`` and of the ``Predictor``
and export tests of ``tests/test_static_inference.py`` that need no
``static.Program`` (those that do are in ``test_torch_static.py``, and
``jit.save`` in ``test_torch_jit.py``; here the port's side calls
``export_layer``). Weights are made on the JAX side and copied into the
port.

- ``export_layer``, fixed and dynamic batch (traced at 2, run at 1, 3
  and 5): the archive's output EQUALS the eager port's and is within
  1e-5 of the JAX archive's, for an MLP and ``llama_tiny``'s forward;
  every module's ``training`` flag is put back;
- the exported programs hold the forward kernels' custom ops: Llama's
  forward K4a, K5a and K6 (``flash_fwd`` a layer, ``rms_norm_fwd`` two a
  layer and one more, ``rope_qk_fwd`` a layer), ``to_int8_inference``'s
  K8 (a projection each), a fused linear K7; each op's CPU body equals
  its plain version bit for bit; the eager forward calls no custom op;
- ``Predictor`` through handles and positional runs, the ``Config``
  switches (``enable_memory_optim`` changes nothing, ROADMAP Queue 3),
  32 concurrent runs from 4 threads;
- ``convert_to_mixed_precision``, both paths: the reference's output
  dtypes (bf16, or f32 where an f32 feed meets bf16 weights) and values
  (tolerances per case);
- ``export_decode`` / ``load_decode``: tokens EQUAL to the port's and the
  JAX package's ``generate()`` and to the JAX archive's, with and without
  eos, on Llama and GPT; the shape contract (``archive serves shape``);
- neither package loads the other's archive (ROADMAP Queue 3), a static
  program's (``export_program``) included.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import inference as jinf
from paddle_tpu.inference.deploy_decode import export_decode as jax_export_decode
from paddle_tpu.inference.deploy_decode import load_decode as jax_load_decode
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.static import InputSpec as JaxInputSpec
from paddle_tpu_torch import inference
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt2_tiny, llama_tiny, load_jax_params)
from paddle_tpu_torch.ops.kernels import custom_ops
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import gemm_epilogue as tge
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm
from paddle_tpu_torch.ops.kernels import rms_norm as trn
from paddle_tpu_torch.ops.kernels import rope as trp
from paddle_tpu_torch.quantization import to_int8_inference
from paddle_tpu_torch.static import InputSpec

V = 256
OPS = torch.ops.paddle_tpu_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one torch thread each keeps the
    test workers (several a machine) from oversubscribing its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bridge(jm, tm):
    jm.eval()
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


@functools.lru_cache(maxsize=1)
def _llama():
    pt.seed(61)
    return _bridge(JaxLlama(jax_llama_tiny()),
                   LlamaForCausalLM(llama_tiny(), device="cpu"))


@functools.lru_cache(maxsize=1)
def _gpt():
    pt.seed(62)
    return _bridge(JaxGPT(jax_gpt2_tiny()),
                   GPTForCausalLM(gpt2_tiny(), device="cpu"))


def _mlp(dropout=None):
    """(JAX MLP, the port's with its weights): Linear 8 -> 16, ReLU,
    Linear 16 -> 4, and a Dropout when asked."""
    pt.seed(63)
    jl = [pt.nn.Linear(8, 16), pt.nn.ReLU(), pt.nn.Linear(16, 4)]
    tl = [tnn.Linear(8, 16, device="cpu"), torch.nn.ReLU(),
          tnn.Linear(16, 4, device="cpu")]
    if dropout is not None:
        jl.append(pt.nn.Dropout(dropout))
        tl.append(torch.nn.Dropout(dropout))
    jm, tm = pt.nn.Sequential(*jl), torch.nn.Sequential(*tl)
    with torch.no_grad():
        for n, p in jm.named_parameters():
            tm.get_parameter(n).copy_(torch.tensor(np.asarray(p.numpy())))
    return jm, tm


def _graph_ops(prog):
    """Custom op name -> calls in a loaded program's graph."""
    counts = {}
    for node in prog.program.graph.nodes:
        name = str(node.target)
        if name.startswith("paddle_tpu_torch."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


def _ids(B, T=8, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


# ------------------------------------------------------------ export_layer


@pytest.mark.parametrize("batch", [2, -1], ids=["fixed", "dynamic"])
def test_export_layer_mlp_equals_eager_and_jax(tmp_path, batch):
    jm, tm = _mlp()
    inference.export_layer(str(tmp_path / "t"), tm,
                           [InputSpec([batch, 8], "float32", "x")])
    jinf.export_layer(str(tmp_path / "j"), jm,
                      [JaxInputSpec([batch, 8], "float32", "x")])
    prog, feeds, fetches = inference.load_exported(str(tmp_path / "t"),
                                                   device="cpu")
    jprog, _, _ = jinf.load_exported(str(tmp_path / "j"))
    assert feeds == ["x"] and fetches == ["output_0"]
    assert prog.feed_specs == [{"name": "x", "shape": [batch, 8],
                                "dtype": "float32"}]
    for bs in ((2,) if batch == 2 else (1, 3, 5)):
        x = np.random.default_rng(bs).standard_normal((bs, 8)).astype(
            np.float32)
        got = prog(x)
        with torch.no_grad():
            want = tm(torch.from_numpy(x))
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(jprog(x)),
                                   rtol=0, atol=1e-5)


def test_export_layer_llama_forward_equals_eager_and_jax(tmp_path):
    jm, tm = _llama()
    inference.export_layer(str(tmp_path / "t"), tm,
                           [InputSpec([-1, 8], "int32", "ids")])
    jinf.export_layer(str(tmp_path / "j"), jm,
                      [JaxInputSpec([2, 8], "int32", "ids")])
    prog, _, _ = inference.load_exported(str(tmp_path / "t"), device="cpu")
    jprog, _, _ = jinf.load_exported(str(tmp_path / "j"))
    L = tm.cfg.num_layers
    assert _graph_ops(prog) == {"flash_fwd": L, "rms_norm_fwd": 2 * L + 1,
                                "rope_qk_fwd": L}
    for bs in (1, 2, 3):
        ids = _ids(bs, seed=bs)
        got = prog(ids)
        with torch.no_grad():
            want = tm(torch.from_numpy(ids))
        assert torch.equal(got, want)
        if bs == 2:
            np.testing.assert_allclose(got.numpy(), np.asarray(jprog(ids)),
                                       rtol=0, atol=1e-5)


def test_export_restores_every_training_flag(tmp_path):
    _, tm = _mlp(dropout=0.5)
    tm.train()
    tm[1].eval()                        # a mixed set of flags survives
    before = [m.training for m in tm.modules()]
    inference.export_layer(str(tmp_path / "m"), tm,
                           [InputSpec([2, 8], "float32", "x")])
    assert [m.training for m in tm.modules()] == before
    prog, _, _ = inference.load_exported(str(tmp_path / "m"), device="cpu")
    x = np.ones((2, 8), np.float32)
    assert torch.equal(prog(x), prog(x))        # exported in eval mode


# ------------------------------------------------------------- custom ops


def test_exported_int8_and_fused_linear_hold_k8_and_k7(tmp_path):
    _, tm = _llama()
    q = to_int8_inference(tm)
    inference.export_layer(str(tmp_path / "q"), q,
                           [InputSpec([2, 8], "int32", "ids")])
    prog, _, _ = inference.load_exported(str(tmp_path / "q"), device="cpu")
    ops = _graph_ops(prog)
    assert ops["quantized_matmul"] == 7 * tm.cfg.num_layers + 1
    ids = _ids(2)
    with torch.no_grad():
        assert torch.equal(prog(ids), q(torch.from_numpy(ids)))

    class FusedMLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(0)
            self.w = torch.nn.Parameter(torch.randn(16, 32, generator=g))
            self.b = torch.nn.Parameter(torch.randn(32, generator=g))

        def forward(self, x):
            return IF.fused_linear_activation(x, self.w, self.b,
                                              activation="gelu")

    f = FusedMLP()
    inference.export_layer(str(tmp_path / "f"), f,
                           [InputSpec([-1, 3, 16], "float32", "x")])
    prog, _, _ = inference.load_exported(str(tmp_path / "f"), device="cpu")
    assert _graph_ops(prog) == {"gemm_epilogue": 1}
    x = torch.randn(5, 3, 16)
    with torch.no_grad():
        assert torch.equal(prog(x), f(x))


def test_custom_op_bodies_equal_their_plain_versions():
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    q, k, v = r(6, 10, 16), r(6, 10, 16), r(6, 10, 16)
    for got, want in zip(OPS.flash_fwd(q, k, v, 0.25, True),
                         tfa._ref_with_lse(q, k, v, 0.25, True)):
        assert torch.equal(got, want)
    x, w = r(3, 5, 64), r(64)
    assert torch.equal(OPS.rms_norm_fwd(x, w, 1e-5),
                       trn._ref_fwd(x, w, 1e-5))
    xq, xk = r(2, 7, 4, 16), r(2, 7, 2, 16)
    cos, sin = r(32, 8), r(32, 8)
    assert torch.equal(OPS.rope_fwd(xq, cos, sin),
                       trp._ref_rope(xq, cos, sin))
    for got, want in zip(OPS.rope_qk_fwd(xq, xk, cos, sin),
                         trp._ref_rope_qk(xq, xk, cos, sin)):
        assert torch.equal(got, want)
    a, b, bias = r(9, 16), r(16, 24), r(24)
    for act in ("none", "relu", "gelu"):
        assert torch.equal(OPS.gemm_epilogue(a, b, bias, act),
                           tge._ref_gemm_epilogue(a, b, bias, act))
    qx = torch.randint(-127, 128, (9, 32), dtype=torch.int8, generator=g)
    qw = torch.randint(-127, 128, (24, 32), dtype=torch.int8, generator=g)
    sx, sw = torch.tensor(0.02), r(24).abs()
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(OPS.quantized_matmul(qx, qw, sx, sw, dt),
                           tqm._ref(qx, qw.t(), sx, sw, dt))
    assert custom_ops.NAMESPACE == "paddle_tpu_torch"


def test_eager_forward_calls_no_custom_op():
    _, tm = _llama()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            tm(torch.from_numpy(_ids(2)))
    names = {e.key for e in prof.key_averages()}
    assert not any(n.startswith("paddle_tpu_torch::") for n in names)


# -------------------------------------------------------------- Predictor


@pytest.fixture(scope="module")
def mlp_archive(tmp_path_factory):
    d = tmp_path_factory.mktemp("mlp")
    _, tm = _mlp()
    inference.export_layer(str(d / "m"), tm,
                           [InputSpec([-1, 8], "float32", "x")])
    return str(d / "m"), tm


def _cpu_config(prefix):
    cfg = inference.Config(prefix + ".pdmodel")
    cfg.disable_gpu()
    return cfg


def test_predictor_handles_and_positional_runs(mlp_archive):
    prefix, tm = mlp_archive
    pred = inference.create_predictor(_cpu_config(prefix))
    assert pred.get_input_names() == ["x"]
    assert pred.get_output_names() == ["output_0"]
    x = np.random.default_rng(4).standard_normal((3, 8)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    h = pred.get_input_handle("x")
    h.copy_from_cpu(x)
    assert h.shape() == [3, 8]
    assert pred.run() is True
    out = pred.get_output_handle("output_0").copy_to_cpu()
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(pred.run([x])[0], want)
    assert inference.get_version() == pt.__version__


def test_config_switches(mlp_archive):
    prefix, _ = mlp_archive
    x = np.ones((1, 8), np.float32)
    ref = inference.create_predictor(_cpu_config(prefix)).run([x])[0]
    cfg = _cpu_config(prefix)
    cfg.enable_memory_optim()
    cfg.enable_profile()
    got = inference.create_predictor(cfg).run([x.copy()])[0]
    np.testing.assert_array_equal(got, ref)     # memory_optim: no effect
    assert cfg.profile_stats()["runs"] == 1
    assert cfg.profile_stats()["total_ms"] > 0
    assert cfg.summary()["memory_optim"] is True
    assert cfg.summary()["device"] == "cpu"
    assert cfg.model_dir() == prefix
    with pytest.raises(NotImplementedError):
        _cpu_config(prefix).switch_ir_optim(False)
    _cpu_config(prefix).switch_ir_optim(True)
    card = inference.Config(prefix)
    assert card.summary()["device"] == "cuda:0"
    card.enable_use_gpu(256, device_id=1)
    assert card.summary()["device"] == "cuda:1"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inference.create_predictor(inference.Config(prefix))


def test_predictor_concurrent_runs_are_isolated(mlp_archive):
    prefix, tm = mlp_archive
    pred = inference.create_predictor(_cpu_config(prefix))

    def call(i):
        return i, pred.run([np.full((2, 8), float(i), np.float32)])[0]

    with ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(call, range(32)))
    for i, out in results:
        with torch.no_grad():
            want = tm(torch.full((2, 8), float(i))).numpy()
        np.testing.assert_array_equal(out, want)


# ------------------------------------------------- mixed precision


@pytest.mark.parametrize("path,layer,rel", [
    ("archive", "mlp", 2 ** -7), ("model", "mlp", 1e-5),
    ("model", "llama", 2e-2)],
    ids=["archive-mlp", "model-mlp", "model-llama"])
def test_convert_to_mixed_precision_matches_jax(tmp_path, path, layer, rel):
    """The reference's output dtype: bf16 for the archive path (outputs
    cast) and a bf16 Llama; f32 for a bf16 MLP fed f32 (the product
    promotes). Values within ``rel`` of the reference's largest: one
    bf16 rounding (archive), f32 sums of the same bf16 weights (MLP),
    a whole bf16 forward computed in each package's order (Llama)."""
    if layer == "mlp":
        jm, tm = _mlp()
        spec, dt, make = [-1, 8], "float32", (
            lambda bs: np.random.default_rng(bs).standard_normal(
                (bs, 8)).astype(np.float32))
    else:
        jm, tm = _llama()
        spec, dt, make = [2, 8], "int32", (lambda bs: _ids(2, seed=bs))
    src_t, src_j = str(tmp_path / "t"), str(tmp_path / "j")
    inference.export_layer(src_t, tm, [InputSpec(spec, dt, "x")])
    jinf.export_layer(src_j, jm, [JaxInputSpec(spec, dt, "x")])
    kw = {"model": tm} if path == "model" else {"device": "cpu"}
    jkw = {"model": jm} if path == "model" else {}
    inference.convert_to_mixed_precision(src_t, src_t + "_bf16", "bf16",
                                         **kw)
    jinf.convert_to_mixed_precision(src_j, src_j + "_bf16", "bf16", **jkw)
    prog, _, _ = inference.load_exported(src_t + "_bf16", device="cpu")
    jprog, _, _ = jinf.load_exported(src_j + "_bf16")
    assert prog.feed_specs[0]["dtype"] == dt          # feeds keep theirs
    for bs in (1, 4):
        x = make(bs)
        got, want = prog(x), np.asarray(jprog(x))
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        want = want.astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rel * np.abs(want).max())
    assert next(tm.parameters()).dtype == torch.float32      # a copy


# ------------------------------------------------------------ export_decode


@pytest.mark.parametrize("family,eos", [("llama", None), ("llama", "3rd"),
                                        ("gpt", None)])
def test_export_decode_equals_generate_and_jax(tmp_path, family, eos):
    jm, tm = _llama() if family == "llama" else _gpt()
    ids = _ids(2, 5, seed=20)
    if eos is not None:
        eos = int(tm.generate(ids, max_new_tokens=6,
                              max_cache_len=11).numpy()[0, 5 + 2])
    paths = inference.export_decode(str(tmp_path / "t"), tm, prompt_len=5,
                                    max_new_tokens=6, batch=2,
                                    eos_token_id=eos)
    assert all(str(tmp_path) in p for p in paths)
    jax_export_decode(str(tmp_path / "j"), jm, prompt_len=5,
                      max_new_tokens=6, batch=2, eos_token_id=eos)
    got = inference.load_decode(str(tmp_path / "t"), device="cpu"
                                ).generate(ids)
    want = tm.generate(ids, max_new_tokens=6, max_cache_len=11,
                       eos_token_id=eos).numpy()
    jwant = jm.generate(jnp.asarray(ids), max_new_tokens=6,
                        max_cache_len=11, eos_token_id=eos).numpy()
    jgot = jax_load_decode(str(tmp_path / "j")).generate(ids)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jwant)
    np.testing.assert_array_equal(got, jgot)


def test_export_decode_shape_contract(tmp_path):
    _, tm = _gpt()
    prefix = str(tmp_path / "g")
    inference.export_decode(prefix, tm, prompt_len=4, max_new_tokens=3,
                            batch=1)
    gen = inference.load_decode(prefix, device="cpu")
    assert gen.generate(np.zeros((1, 4), np.int32)).shape == (1, 7)
    for bad in ((2, 4), (1, 6)):
        with pytest.raises(ValueError, match="archive serves shape"):
            gen.generate(np.zeros(bad, np.int32))
    with pytest.raises(ValueError, match="exceeds max_cache_len"):
        inference.export_decode(prefix, tm, prompt_len=4, max_new_tokens=3,
                                max_cache_len=6)


# ------------------------------------------------------------ the formats


def test_neither_package_loads_the_others_archive(tmp_path):
    jm, tm = _mlp()
    inference.export_layer(str(tmp_path / "t"), tm,
                           [InputSpec([2, 8], "float32", "x")])
    jinf.export_layer(str(tmp_path / "j"), jm,
                      [JaxInputSpec([2, 8], "float32", "x")])
    with pytest.raises(ValueError, match="jax.export StableHLO"):
        inference.load_exported(str(tmp_path / "j"), device="cpu")
    with pytest.raises(Exception):
        jinf.load_exported(str(tmp_path / "t"))
    # a static program's archive (export_program) is the port's format too
    import paddle_tpu_torch.static as tst
    main = tst.Program()
    with tst.program_guard(main):
        x = tst.data("x", [2, 8], "float32")
        y = x * 2.0
    from paddle_tpu_torch.device import default_place
    with default_place("cpu"):      # a program without weights: traced there
        inference.export_program(str(tmp_path / "p"), main, ["x"],
                                 [y.name], tst.global_scope())
    prog, _, _ = inference.load_exported(str(tmp_path / "p"), device="cpu")
    from paddle_tpu_torch.inference.export import FORMAT
    assert prog.meta["format"] == FORMAT
    with pytest.raises(Exception):
        jinf.load_exported(str(tmp_path / "p"))
    spec = InputSpec.from_tensor(torch.zeros(3, 4, dtype=torch.bfloat16),
                                 name="h")
    assert (spec.shape, spec.dtype, spec.name) == ([3, 4], "bfloat16", "h")

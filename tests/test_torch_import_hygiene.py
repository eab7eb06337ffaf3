"""The port imports neither JAX nor the JAX package.

A static AST scan of every ``.py`` under ``paddle_tpu_torch/``, of
``chip_smoke.py`` and of ``tests/_torch_remote_stub.py`` (the factories
spawned port hosts import): no ``import``/``from`` statement may have a
top-level module name of ``jax``, ``jaxlib`` or ``paddle_tpu`` (compared
exactly — ``paddle_tpu_torch`` shares the prefix). Static, not
``sys.modules``: the environment may import jax at interpreter start.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_remote_stub.py"]


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [(line, name) for line, name in _top_level_imports(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "tests/_torch_remote_stub.py" in names
    assert "paddle_tpu_torch/inference/continuous_batching.py" in names
    assert {"paddle_tpu_torch/nn/functional.py",
            "paddle_tpu_torch/optimizer/optimizer.py",
            "paddle_tpu_torch/jit/__init__.py",
            "paddle_tpu_torch/ops/kernels/flash_attention.py",
            "paddle_tpu_torch/ops/kernels/rms_norm.py",
            "paddle_tpu_torch/ops/kernels/rope.py",
            "paddle_tpu_torch/ops/rope.py",
            "paddle_tpu_torch/models/llama.py",
            "paddle_tpu_torch/ops/kernels/gemm_epilogue.py",
            "paddle_tpu_torch/ops/kernels/quant_matmul.py",
            "paddle_tpu_torch/nn/layer.py",
            "paddle_tpu_torch/quantization/qat.py",
            "paddle_tpu_torch/incubate/nn/functional.py",
            "paddle_tpu_torch/incubate/nn/fused_transformer.py",
            "paddle_tpu_torch/optimizer/lr.py",
            "paddle_tpu_torch/nn/clip.py",
            "paddle_tpu_torch/amp/__init__.py",
            "paddle_tpu_torch/parallel/recompute_util.py",
            "paddle_tpu_torch/models/bridge.py",
            "paddle_tpu_torch/ops/kernels/multi_tensor_adam.py",
            "paddle_tpu_torch/reliability/health.py",
            "paddle_tpu_torch/reliability/supervisor.py",
            "paddle_tpu_torch/telemetry/costs.py",
            "paddle_tpu_torch/telemetry/serving.py",
            "paddle_tpu_torch/telemetry/exposition.py",
            "paddle_tpu_torch/models/costs.py",
            "paddle_tpu_torch/inference/serving.py",
            "paddle_tpu_torch/inference/kv_tier.py",
            "paddle_tpu_torch/inference/placement.py",
            "paddle_tpu_torch/inference/router.py",
            "paddle_tpu_torch/inference/transport.py",
            "paddle_tpu_torch/inference/remote.py",
            "paddle_tpu_torch/models/gpt.py",
            "paddle_tpu_torch/models/mixtral.py",
            "paddle_tpu_torch/models/generation.py",
            "paddle_tpu_torch/inference/decode_loop.py",
            "paddle_tpu_torch/inference/speculative.py",
            "paddle_tpu_torch/inference/export.py",
            "paddle_tpu_torch/inference/deploy_decode.py",
            "paddle_tpu_torch/inference/__init__.py",
            "paddle_tpu_torch/ops/kernels/custom_ops.py",
            "paddle_tpu_torch/static/__init__.py",
            "paddle_tpu_torch/core/dtype.py",
            "paddle_tpu_torch/core/tape.py",
            "paddle_tpu_torch/core/tensor.py",
            "paddle_tpu_torch/ops/registry.py",
            "paddle_tpu_torch/ops/creation.py",
            "paddle_tpu_torch/ops/math.py",
            "paddle_tpu_torch/ops/manipulation.py",
            "paddle_tpu_torch/ops/linalg.py",
            "paddle_tpu_torch/ops/optable.py",
            "paddle_tpu_torch/ops/random_ops.py",
            "paddle_tpu_torch/autograd/__init__.py",
            "paddle_tpu_torch/core/prng.py",
            "paddle_tpu_torch/nn/initializer.py",
            "paddle_tpu_torch/nn/param_attr.py",
            "paddle_tpu_torch/nn/layers_basic.py",
            "paddle_tpu_torch/nn/rnn.py",
            "paddle_tpu_torch/nn/transformer.py",
            "paddle_tpu_torch/nn/utils/__init__.py",
            "paddle_tpu_torch/nn/layers_tail.py",
            "paddle_tpu_torch/models/_stem.py",
            "paddle_tpu_torch/models/bert.py",
            "paddle_tpu_torch/models/dit.py",
            "paddle_tpu_torch/models/qwen_vl.py",
            "paddle_tpu_torch/static/graph.py",
            "paddle_tpu_torch/static/executor.py",
            "paddle_tpu_torch/static/program.py",
            "paddle_tpu_torch/static/passes.py",
            "paddle_tpu_torch/static/io.py",
            "paddle_tpu_torch/static/nn.py",
            "paddle_tpu_torch/jit/dy2static.py",
            "paddle_tpu_torch/vision/__init__.py",
            "paddle_tpu_torch/vision/transforms.py",
            "paddle_tpu_torch/vision/datasets.py",
            "paddle_tpu_torch/vision/models.py",
            "paddle_tpu_torch/vision/models_ext.py",
            "paddle_tpu_torch/vision/ops.py",
            "paddle_tpu_torch/fft.py",
            "paddle_tpu_torch/signal.py",
            "paddle_tpu_torch/linalg.py"} <= names
    assert len(names) >= 80


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\nimport jax.numpy as jnp\n"
                 "from paddle_tpu.models import llama\n"
                 "from paddle_tpu_torch import device\n"
                 "from . import sibling\n")
    found = {name for _, name in _top_level_imports(p)}
    assert found & FORBIDDEN == {"jax", "paddle_tpu"}

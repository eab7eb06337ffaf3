"""The port imports neither JAX nor the JAX package.

A static AST scan of every ``.py`` under ``paddle_tpu_torch/`` and of
``chip_smoke.py``: no ``import``/``from`` statement may have a
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
    + [ROOT / "chip_smoke.py"]


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
            "paddle_tpu_torch/ops/kernels/multi_tensor_adam.py"} <= names
    assert len(names) >= 43


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\nimport jax.numpy as jnp\n"
                 "from paddle_tpu.models import llama\n"
                 "from paddle_tpu_torch import device\n"
                 "from . import sibling\n")
    found = {name for _, name in _top_level_imports(p)}
    assert found & FORBIDDEN == {"jax", "paddle_tpu"}

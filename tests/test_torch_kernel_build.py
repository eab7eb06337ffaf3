"""The port's kernel build (``paddle_tpu_torch/ops/kernels/_build.py``)
names each library by a hash of its source, the shared headers and
nvcc's flags, so an edit to either rebuilds it. Only names are computed
here: no nvcc is needed."""
import re
import shutil

from paddle_tpu_torch.ops.kernels import _build


def test_library_name_follows_the_source_and_the_shared_header(
        tmp_path, monkeypatch):
    for f in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "fused_tick.cu"
    other = tmp_path / "paged_attention.cu"
    first = _build._target(src), _build._target(other)
    assert first == (_build._target(src), _build._target(other))
    header = tmp_path / "attention_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build._target(src), _build._target(other)
    assert second[0] != first[0] and second[1] != first[1]
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target(src) not in (first[0], second[0])
    assert _build._target(other) == second[1]


def test_every_local_include_is_a_hashed_header_beside_the_sources():
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert {s.stem for s in sources} >= {"paged_attention", "ragged_prefill",
                                         "fused_tick", "flash_attention",
                                         "rms_norm", "rope", "gemm_epilogue",
                                         "quant_matmul", "multi_tensor_adam",
                                         "sample_rows", "threefry_fill"}
    for src in sources:
        for name in re.findall(r'^#include "([^"]+)"', src.read_text(),
                               flags=re.M):
            assert name.endswith(".cuh") and "/" not in name, (src, name)
            assert (_build.CSRC / name).is_file(), (src, name)


def test_library_name_follows_the_nvcc_flags(monkeypatch):
    src = _build.CSRC / "gemm_epilogue.cu"
    before = _build._target(src)
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build._target(src) != before

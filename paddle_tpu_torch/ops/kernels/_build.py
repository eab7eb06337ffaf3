"""Build and load the port's hand-written CUDA kernels.

Counterpart of ``paddle_tpu/ops/pallas/__init__.py``: where the JAX
package hands Pallas kernels to Mosaic at trace time, the port compiles
``paddle_tpu_torch/csrc/*.cu`` with ``nvcc`` at first use into one
shared library per source, each exporting a plain C launch function,
and binds them with ``ctypes`` (route (b) of building a kernel: a file
with a C interface builds in seconds; one that includes PyTorch's
headers takes minutes).

Libraries land in ``build/paddle_tpu_torch/`` at the repository root,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited kernel or header is rebuilt and an unchanged one
is reused. All missing libraries are built together, one ``nvcc``
process per source started at once. A missing ``nvcc`` or a failed
build raises with nvcc's output; nothing here falls back to anything.

Nothing is compiled or loaded at import time: the CPU tests import
every module of the port on a machine with no CUDA toolkit.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_all", "library", "function",
           "build_log", "build_seconds"]

_PKG = Path(__file__).resolve().parents[2]           # paddle_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}          # source stem -> loaded ctypes.CDLL
_fns = {}           # (stem, name) -> C function with its argument types
_log = {}           # source stem -> {"seconds", "ptxas"} of a fresh build
_build_s = [0.0]    # wall seconds of the build_all calls that compiled


def _nvcc():
    """Path of ``nvcc``: PATH first, then ``$CUDA_HOME/bin``, then the
    toolkit's default install prefix."""
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use and need "
        "the CUDA toolkit")


def _target(src):
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_all():
    """Compile every ``csrc/*.cu`` whose library is missing — all at
    once, one ``nvcc`` per source — and load every library. Returns
    {stem: seconds spent building it (0.0 when reused)}. Raises
    RuntimeError carrying nvcc's output if any build fails."""
    with _lock:
        todo = [(s, _target(s)) for s in _sources() if s.stem not in _libs]
        missing = [(s, t) for s, t in todo if not t.exists()]
        secs = {s.stem: 0.0 for s, _ in todo}
        if missing:
            t_all = time.perf_counter()
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = []
            for src, out in missing:
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, time.perf_counter(),
                              subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE,
                                               text=True)))
            errors = []
            for src, out, tmp, t0, proc in procs:
                stdout, stderr = proc.communicate()
                secs[src.stem] = time.perf_counter() - t0
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    errors.append(f"nvcc failed on {src.name} "
                                  f"(exit {proc.returncode}):\n"
                                  f"{stdout}{stderr}")
                    continue
                os.replace(tmp, out)     # atomic: racing builders agree
                _log[src.stem] = {"seconds": secs[src.stem],
                                  "ptxas": stdout + stderr}
            _build_s[0] += time.perf_counter() - t_all
            if errors:
                raise RuntimeError("\n".join(errors))
        for src, out in todo:
            _libs[src.stem] = ctypes.CDLL(str(out))
        return secs


def library(stem):
    """The loaded library built from ``csrc/<stem>.cu`` (building every
    missing library first)."""
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        lib = _libs.get(stem)
        if lib is None:
            raise RuntimeError(f"no kernel source csrc/{stem}.cu")
    return lib


def function(stem, name, argtypes):
    """The C launch function ``name`` of ``csrc/<stem>.cu``, returning a
    C int, with ``argtypes`` set once: every later call of a wrapper gets
    the same bound function without touching ctypes again."""
    fn = _fns.get((stem, name))
    if fn is None:
        fn = getattr(library(stem), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[stem, name] = fn
    return fn


def build_seconds():
    """Wall seconds this process spent compiling kernel libraries (the
    ``build_all`` calls that found a library missing)."""
    return _build_s[0]


def build_log():
    """{stem: {"seconds", "ptxas"}} for libraries compiled by this
    process — ptxas's register and shared-memory report per kernel."""
    return dict(_log)

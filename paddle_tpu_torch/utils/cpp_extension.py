"""Custom C++ op toolchain (paddle.utils.cpp_extension parity).

Port of ``paddle_tpu/utils/cpp_extension.py`` (reference:
python/paddle/utils/cpp_extension/cpp_extension.py:800 ``load``,
CppExtension/CUDAExtension/BuildExtension/setup, and the PD_BUILD_OP
custom op protocol). A custom C++ op is HOST code, as in the reference:
``load()`` compiles sources with ``g++`` into a shared library in
``get_build_directory()`` and binds it with ``ctypes``;
``elementwise_op`` lifts an ``extern "C"`` function into a
``torch.autograd.Function`` (differentiable when given a gradient
function) and ``custom_op`` lifts the multi-input form. A tensor on the
card is copied to the host for the call and the result copied back to
the input's device, as the reference's ``jax.pure_callback`` does. Both
take torch tensors or paddle ``Tensor``s, eagerly and under
``jit.to_static``.

A build is locked and atomic: one process compiles to a temporary name
under a file lock and renames the library into place, so processes that
load the same sources at once (parallel test workers) never see a
half-written library. A missing ``g++`` or a failed build raises with the
compiler's output.

C ABI expected from user kernels (dense f32/f64 arrays):
    extern "C" void op(const T** inputs, const long long* sizes,
                       int n_inputs, T* out);
or the simpler unary form ``void f(const T* x, long long n, T* y)``
used via ``elementwise_op``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile

import numpy as np

__all__ = ["load", "CppExtension", "CUDAExtension", "BuildExtension",
           "setup", "get_build_directory", "ExtensionModule"]


def get_build_directory(verbose=False):
    d = os.environ.get("PADDLE_EXTENSION_DIR",
                       os.path.join(tempfile.gettempdir(),
                                    "paddle_tpu_torch_extensions"))
    os.makedirs(d, exist_ok=True)
    return d


def _build_shared(out_path, command):
    """Make the library ``out_path`` with ``command(tmp_path)`` (an argv
    writing ``tmp_path``) unless it exists: under an exclusive lock on
    ``out_path + ".lock"``, compiled to a name of this process and
    renamed into place. Returns ``out_path``; raises RuntimeError with
    the compiler's output when the command fails or is missing."""
    if os.path.exists(out_path):
        return out_path
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out_path):      # built while we waited
                return out_path
            tmp = f"{out_path}.{os.getpid()}.tmp"
            cmd = command(tmp)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(
                    f"compilation of {os.path.basename(out_path)} failed: "
                    f"{cmd[0]} not found ({e})") from None
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise RuntimeError(
                    f"compilation of {os.path.basename(out_path)} failed "
                    f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out_path


def _compile(name, sources, extra_cxx_cflags, extra_ldflags,
             extra_include_paths, build_directory, verbose):
    build_dir = build_directory or get_build_directory()
    srcs = [os.path.abspath(s) for s in sources]
    tag = hashlib.sha1()
    for s in srcs:
        with open(s, "rb") as f:
            tag.update(f.read())
    # everything that changes the build output must key the cache
    # (headers reached via -I are not tracked; bump a flag to force)
    tag.update(" ".join(extra_cxx_cflags or []).encode())
    tag.update(b"|" + " ".join(extra_ldflags or []).encode())
    tag.update(b"|" + " ".join(extra_include_paths or []).encode())
    so_path = os.path.join(build_dir, f"{name}_{tag.hexdigest()[:12]}.so")

    def command(out):
        cmd = (["g++", "-O2", "-fPIC", "-shared", "-std=c++17"]
               + [f"-I{p}" for p in (extra_include_paths or [])]
               + (extra_cxx_cflags or []) + srcs
               + ["-o", out] + (extra_ldflags or []))
        if verbose:
            print("cpp_extension:", " ".join(cmd))
        return cmd

    return _build_shared(so_path, command)


def _host(t, dtype):
    """``t`` (a torch tensor or an array) as a C-contiguous numpy array of
    ``dtype`` on the host."""
    import torch
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t, dtype=dtype)


def _lift(fn, name):
    """``fn`` (torch tensors in, a torch tensor out) taking paddle
    ``Tensor``s too, through the port's dispatch."""
    from ..core.tensor import dispatch

    def op(*args):
        return dispatch(fn, *args, name=name)

    op.__name__ = name
    return op


class ExtensionModule:
    """Handle over a JIT-built .so: raw ctypes access + op lifting."""

    def __init__(self, name, so_path):
        self.name = name
        self.so_path = so_path
        self.lib = ctypes.CDLL(so_path)

    def _sym(self, symbol):
        try:
            return getattr(self.lib, symbol)
        except AttributeError:
            raise AttributeError(
                f"extension {self.name!r} has no symbol {symbol!r}; did you "
                f"declare it extern \"C\"?") from None

    def elementwise_op(self, symbol, grad_symbol=None, dtype=np.float32):
        """Lift ``void f(const T* x, long long n, T* y)`` into an op on
        tensors. With grad_symbol ``void g(const T* x, const T* gy, long
        long n, T* gx)``, the op is differentiable; without it, a
        backward through the op raises."""
        import torch

        fwd_c = self._sym(symbol)
        ct = ctypes.c_float if dtype == np.float32 else ctypes.c_double
        ptr = ctypes.POINTER(ct)
        fwd_c.argtypes = [ptr, ctypes.c_longlong, ptr]
        fwd_c.restype = None
        bwd_c = None
        if grad_symbol is not None:
            bwd_c = self._sym(grad_symbol)
            bwd_c.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
            bwd_c.restype = None

        def host_fwd(x):
            x = _host(x, dtype)
            out = np.empty_like(x)
            fwd_c(x.ctypes.data_as(ptr), x.size, out.ctypes.data_as(ptr))
            return out

        def host_bwd(x, gy):
            x, gy = _host(x, dtype), _host(gy, dtype)
            gx = np.empty_like(x)
            bwd_c(x.ctypes.data_as(ptr), gy.ctypes.data_as(ptr), x.size,
                  gx.ctypes.data_as(ptr))
            return gx

        class HostOp(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return torch.from_numpy(host_fwd(x)).to(x.device)

            @staticmethod
            def backward(ctx, gy):
                if bwd_c is None:
                    raise RuntimeError(
                        f"op {symbol!r} of extension {self.name!r} has no "
                        "grad_symbol: it is not differentiable")
                x, = ctx.saved_tensors
                return torch.from_numpy(host_bwd(x, gy)).to(x.device)

        return _lift(HostOp.apply, symbol)

    def custom_op(self, symbol, n_inputs, out_shape_fn=None,
                  dtype=np.float32):
        """Lift the generic multi-input ABI:
        void f(const T** ins, const long long* sizes, int n, T* out).
        out_shape_fn(*input_shapes) -> output shape (default: first
        input's shape, mirroring most elementwise custom ops). The result
        is on the first tensor input's device and carries no gradient."""
        import torch

        fn_c = self._sym(symbol)
        ct = ctypes.c_float if dtype == np.float32 else ctypes.c_double
        ptr = ctypes.POINTER(ct)
        fn_c.argtypes = [ctypes.POINTER(ptr),
                         ctypes.POINTER(ctypes.c_longlong),
                         ctypes.c_int, ptr]
        fn_c.restype = None

        def run(*args):
            arrs = [_host(a, dtype) for a in args]
            shape = out_shape_fn(*[a.shape for a in arrs]) \
                if out_shape_fn else arrs[0].shape
            out = np.empty(tuple(shape), dtype=dtype)
            ins = (ptr * len(arrs))(*[a.ctypes.data_as(ptr) for a in arrs])
            sizes = (ctypes.c_longlong * len(arrs))(
                *[a.size for a in arrs])
            fn_c(ins, sizes, len(arrs), out.ctypes.data_as(ptr))
            device = next((a.device for a in args
                           if isinstance(a, torch.Tensor)), "cpu")
            return torch.from_numpy(out).to(device)

        return _lift(run, symbol)


def load(name, sources, extra_cxx_cflags=None, extra_cuda_cflags=None,
         extra_ldflags=None, extra_include_paths=None, build_directory=None,
         verbose=False):
    """JIT-compile C++ sources with g++ and return an ExtensionModule
    (reference cpp_extension.py:800 — same signature; the cuda flags are
    accepted and ignored: a custom op here is host code, as in the
    reference)."""
    so_path = _compile(name, sources, extra_cxx_cflags, extra_ldflags,
                       extra_include_paths, build_directory, verbose)
    return ExtensionModule(name, so_path)


# ------------------------------------------------- setuptools-style parity

def CppExtension(sources, *args, **kwargs):
    from setuptools import Extension
    name = kwargs.pop("name", None) or "paddle_tpu_custom_ext"
    return Extension(name, sources, *args, **kwargs)


def CUDAExtension(sources, *args, **kwargs):
    import warnings
    warnings.warn("CUDAExtension: building as host-side C++, as the "
                  "reference does (a custom op is host code; the port's "
                  "device code is its own kernels)")
    return CppExtension(sources, *args, **kwargs)


try:
    from setuptools.command.build_ext import build_ext as _build_ext

    class BuildExtension(_build_ext):
        @classmethod
        def with_options(cls, **options):
            return cls
except ImportError:  # pragma: no cover
    BuildExtension = None


def setup(**attr):
    from setuptools import setup as _setup
    attr.setdefault("cmdclass", {})
    if BuildExtension is not None:
        attr["cmdclass"].setdefault("build_ext", BuildExtension)
    return _setup(**attr)

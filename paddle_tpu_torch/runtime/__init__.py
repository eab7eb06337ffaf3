"""Native runtime: ctypes bindings over the port's runtime library.

Port of ``paddle_tpu/runtime/__init__.py``. The C++ pieces the reference
keeps native stay native here: the TCPStore rendezvous
(``csrc/tcp_store.cc``), the FLAGS_ registry (``csrc/flags.cc``) and the
lock-free shared-memory ring (``csrc/shm_ring.cc``), the three files
copied from the JAX package. The library is built at first use with
``g++`` into ``build/paddle_tpu_torch/runtime/`` at the repository root,
named by a hash of the sources and the flags (as the kernels are named,
``ops/kernels/_build.py``), under a file lock and renamed into place
(``utils.cpp_extension._build_shared``): test processes that start at
once never build into one file together or load a half-written one. A
missing ``g++`` or a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_SOURCES = ("tcp_store.cc", "flags.cc", "shm_ring.cc")
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
_LIBS = ("-lpthread", "-lrt")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "paddle_tpu_torch", "runtime")
_lock = threading.Lock()
_lib = None


def _lib_path():
    h = hashlib.sha256()
    for f in _SOURCES:
        with open(os.path.join(_CSRC, f), "rb") as src:
            h.update(src.read())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libpaddle_tpu_torch_rt-{h.hexdigest()[:16]}.so")


def build_library(force=False):
    """The runtime library's path, built with g++ when missing (or
    ``force``: rebuilt). Raises RuntimeError with g++'s output."""
    from ..utils.cpp_extension import _build_shared
    path = _lib_path()
    if force and os.path.exists(path):
        os.unlink(path)
    srcs = [os.path.join(_CSRC, f) for f in _SOURCES]
    return _build_shared(path, lambda out: ["g++", *_FLAGS, "-o", out,
                                             *srcs, *_LIBS])


def lib():
    global _lib
    with _lock:
        if _lib is None:
            path = build_library()
            L = ctypes.CDLL(path)
            L.pt_store_server_start.restype = ctypes.c_void_p
            L.pt_store_server_start.argtypes = [ctypes.c_int]
            L.pt_store_server_port.restype = ctypes.c_int
            L.pt_store_server_port.argtypes = [ctypes.c_void_p]
            L.pt_store_server_stop.argtypes = [ctypes.c_void_p]
            L.pt_store_client_connect.restype = ctypes.c_void_p
            L.pt_store_client_connect.argtypes = [ctypes.c_char_p,
                                                  ctypes.c_int, ctypes.c_int]
            L.pt_store_set.restype = ctypes.c_int
            L.pt_store_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_int]
            L.pt_store_get.restype = ctypes.c_long
            L.pt_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_long]
            L.pt_store_add.restype = ctypes.c_longlong
            L.pt_store_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_longlong]
            L.pt_store_check.restype = ctypes.c_int
            L.pt_store_check.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            L.pt_store_del.restype = ctypes.c_int
            L.pt_store_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            L.pt_store_client_close.argtypes = [ctypes.c_void_p]
            L.pt_flags_set.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            L.pt_flags_get.restype = ctypes.c_char_p
            L.pt_flags_get.argtypes = [ctypes.c_char_p]
            L.pt_flags_has.restype = ctypes.c_int
            L.pt_flags_has.argtypes = [ctypes.c_char_p]
            L.pt_flags_list.restype = ctypes.c_char_p
            L.shm_ring_create.restype = ctypes.c_void_p
            L.shm_ring_create.argtypes = [ctypes.c_char_p,
                                          ctypes.c_uint64,
                                          ctypes.c_uint32]
            L.shm_ring_attach.restype = ctypes.c_void_p
            L.shm_ring_attach.argtypes = [ctypes.c_char_p]
            L.shm_ring_push.restype = ctypes.c_int
            L.shm_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint64, ctypes.c_int]
            L.shm_ring_pop.restype = ctypes.c_int64
            L.shm_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_uint64, ctypes.c_int]
            L.shm_ring_size.restype = ctypes.c_uint64
            L.shm_ring_size.argtypes = [ctypes.c_void_p]
            L.shm_ring_slot_size.restype = ctypes.c_uint64
            L.shm_ring_slot_size.argtypes = [ctypes.c_void_p]
            L.shm_ring_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
            _lib = L
    return _lib


class ShmRing:
    """Lock-free SPSC shared-memory ring (native csrc/shm_ring.cc) —
    the DataLoader's worker->main batch transport (reference C++
    buffered_reader over shared memory). ``create=True`` owns the
    segment (and unlinks it on close); workers ``attach``."""

    def __init__(self, name, slot_size=1 << 23, n_slots=8, create=True):
        self.name = name
        self._own = create
        self.slot_size = slot_size
        self._buf = None                 # lazy persistent pop buffer
        if create:
            self._h = lib().shm_ring_create(name.encode(), slot_size,
                                            n_slots)
        else:
            self._h = lib().shm_ring_attach(name.encode())
        if not self._h:
            raise RuntimeError(f"shm_ring {'create' if create else 'attach'}"
                               f" failed for {name!r}")
        if not create:
            # the creator owns the true slot size; read it back
            self.slot_size = int(lib().shm_ring_slot_size(self._h))

    def push(self, data, timeout_ms=-1):
        rc = lib().shm_ring_push(self._h, bytes(data), len(data),
                                 timeout_ms)
        if rc == -2:
            raise ValueError(f"payload {len(data)} bytes exceeds the "
                             "ring slot size")
        return rc == 0

    def pop(self, max_len=None, timeout_ms=-1):
        if timeout_ms == 0 and len(self) == 0:
            return None                  # cheap empty probe: no buffer
        cap = max_len or self.slot_size
        if self._buf is None or len(self._buf) < cap:
            self._buf = ctypes.create_string_buffer(cap)
        n = lib().shm_ring_pop(self._h, self._buf, cap, timeout_ms)
        if n == -1:
            return None
        if n == -2:
            raise ValueError("ring payload larger than max_len")
        return self._buf.raw[:n]

    def __len__(self):
        return int(lib().shm_ring_size(self._h))

    def close(self):
        if self._h:
            lib().shm_ring_close(self._h, 1 if self._own else 0)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class TCPStoreServer:
    """Rank-0 side of the rendezvous (reference tcp_store.cc MasterDaemon)."""

    def __init__(self, port=0):
        self._h = lib().pt_store_server_start(port)
        if not self._h:
            raise RuntimeError(f"failed to bind TCPStore on port {port}")

    @property
    def port(self):
        return lib().pt_store_server_port(self._h)

    def stop(self):
        if self._h:
            lib().pt_store_server_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class TCPStore:
    """Client (reference phi TCPStore API: set/get/add/wait).

    Thread-safe: one request/reply cycle at a time per connection — the
    elastic manager heartbeats from a daemon thread while the main
    thread polls membership, and interleaved writes on the shared
    socket would corrupt the length-prefixed protocol (observed as a
    blocked check() waiting on a reply the other thread consumed).
    """

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30):
        self._server = None
        self._io_lock = threading.Lock()
        if is_master:
            self._server = TCPStoreServer(port)
            port = self._server.port
        self.host = host
        self.port = port
        self._h = lib().pt_store_client_connect(host.encode(), port,
                                                int(timeout * 1000))
        if not self._h:
            raise TimeoutError(f"cannot reach TCPStore at {host}:{port}")

    def set(self, key, value):
        data = value if isinstance(value, bytes) else str(value).encode()
        with self._io_lock:
            rc = lib().pt_store_set(self._h, key.encode(), data,
                                    len(data))
        if rc != 0:
            raise RuntimeError("TCPStore.set failed")

    def get(self, key, max_len=1 << 20):
        buf = ctypes.create_string_buffer(max_len)
        with self._io_lock:
            n = lib().pt_store_get(self._h, key.encode(), buf, max_len)
        if n < 0:
            raise RuntimeError("TCPStore.get failed")
        return buf.raw[:n]

    wait = get

    def add(self, key, delta=1):
        with self._io_lock:
            out = lib().pt_store_add(self._h, key.encode(), delta)
        if out == -1:
            raise RuntimeError("TCPStore.add failed")
        return int(out)

    def check(self, key):
        with self._io_lock:
            return bool(lib().pt_store_check(self._h, key.encode()))

    def delete_key(self, key):
        with self._io_lock:
            return lib().pt_store_del(self._h, key.encode()) == 0

    def barrier(self, name, world_size, timeout=60):
        """Counter barrier over the store (launcher sync primitive)."""
        import time
        n = self.add(f"__barrier__{name}", 1)
        deadline = time.time() + timeout
        while time.time() < deadline:
            cur = self.add(f"__barrier__{name}", 0)
            if cur >= world_size:
                return True
            time.sleep(0.02)
        raise TimeoutError(f"barrier {name} timed out at {n}/{world_size}")

    def close(self):
        if self._h:
            lib().pt_store_client_close(self._h)
            self._h = None
        if self._server:
            self._server.stop()


# ------------------------------------------------------------------- flags


def set_flags(flags: dict):
    """paddle.set_flags parity (framework.py:7736)."""
    for k, v in flags.items():
        name = k[6:] if k.startswith("FLAGS_") else k
        lib().pt_flags_set(name.encode(), str(v).encode())
    # live hooks: flags that change framework behavior immediately
    if any(k.endswith("check_nan_inf") or k.endswith("check_nan_inf_level")
           for k in flags):
        from ..core.tensor import set_nan_inf_check
        cur = get_flags(["FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level"])
        set_nan_inf_check(cur["FLAGS_check_nan_inf"] or 0,
                          cur["FLAGS_check_nan_inf_level"] or 0)


def get_flags(names):
    """paddle.get_flags parity."""
    single = isinstance(names, str)
    names_list = [names] if single else list(names)
    out = {}
    for k in names_list:
        name = k[6:] if k.startswith("FLAGS_") else k
        v = lib().pt_flags_get(name.encode())
        out[k] = v.decode() if v is not None else None
    return out


def list_flags():
    raw = lib().pt_flags_list().decode()
    return dict(line.split("=", 1) for line in raw.splitlines() if "=" in line)

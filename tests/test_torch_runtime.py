"""The port's native runtime (``runtime``: the FLAGS_ registry, TCPStore,
ShmRing) and the DataLoader's native ring, on the CPU.

- ``tests/test_runtime_native.py``'s three cases on the port's
  ``runtime`` (its library built by g++ from
  ``paddle_tpu_torch/runtime/csrc``, the JAX package's three files copied,
  into ``build/paddle_tpu_torch/runtime/``); ``get_flags`` / ``set_flags``
  at the top level, with the live hook into the NaN/Inf check;
- the build is race-free: processes that build one library at once (the
  parallel test workers) run the compiler once, under the lock,
  and every one of them loads the finished file (``_build_shared``, also
  the build of ``utils.cpp_extension``); a failed build raises with the
  compiler's output and leaves nothing behind;
- ``ShmRing`` (names carry the process id, so parallel workers never
  share a segment) round-trips payloads, refuses an oversized one;
- ``tests/test_dataloader_mp.py``'s three native-ring cases: the ring's
  batches equal the JAX package's loader's (its queue transport: the
  reference's own ring would build into the JAX package) and the port's
  queue transport's; a batch larger than a slot crosses as shared-memory
  references; one that cannot shrink raises naming the ring slot, the
  worker alive.
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import runtime, sysconfig
from paddle_tpu_torch.core import tensor as tcore
from paddle_tpu_torch.utils import cpp_extension

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_and_flags():
    runtime.set_flags({"FLAGS_check_nan_inf": "1",
                       "allocator_strategy": "auto_growth"})
    try:
        out = runtime.get_flags(["FLAGS_check_nan_inf", "FLAGS_missing"])
        assert out["FLAGS_check_nan_inf"] == "1"
        assert out["FLAGS_missing"] is None
        assert runtime.list_flags()["allocator_strategy"] == "auto_growth"
        assert tcore._check_nan_inf          # the live hook
    finally:
        runtime.set_flags({"FLAGS_check_nan_inf": "0"})
    assert not tcore._check_nan_inf
    path = runtime.build_library()
    assert path.startswith(os.path.join(ROOT, "build", "paddle_tpu_torch",
                                        "runtime"))
    assert sysconfig.get_lib() == os.path.dirname(path)
    assert sorted(os.listdir(sysconfig.get_include())) == [
        "flags.cc", "shm_ring.cc", "tcp_store.cc"]


def test_top_level_flags_are_the_runtimes():
    pt.set_flags({"FLAGS_some_port_flag": 3})
    assert pt.get_flags("FLAGS_some_port_flag") == {
        "FLAGS_some_port_flag": "3"}
    assert pt.get_flags(["some_port_flag"]) == {"some_port_flag": "3"}


def test_tcp_store_set_get_add():
    master = runtime.TCPStore(is_master=True, port=0)
    client = runtime.TCPStore(host="127.0.0.1", port=master.port)
    master.set("unique_id", b"\x01\x02\x03nccl-equivalent")
    assert client.get("unique_id") == b"\x01\x02\x03nccl-equivalent"
    assert client.add("counter", 5) == 5
    assert master.add("counter", 2) == 7
    assert client.check("unique_id")
    assert not client.check("nope")
    client.delete_key("unique_id")
    assert not master.check("unique_id")
    client.close()
    master.close()


def test_a_write_is_visible_to_every_connection_on_return():
    """SET and DEL are acknowledged once applied (the reference's are
    fire-and-forget, so a CHECK on another connection could overtake
    them: ``test_runtime_native.py::test_tcp_store_set_get_add``'s
    flake)."""
    master = runtime.TCPStore(is_master=True, port=0)
    client = runtime.TCPStore(port=master.port)
    try:
        for i in range(300):
            client.set(f"k{i}", b"v")
            assert master.check(f"k{i}")
            client.delete_key(f"k{i}")
            assert not master.check(f"k{i}")
    finally:
        client.close()
        master.close()


def test_tcp_store_blocking_get_and_barrier():
    master = runtime.TCPStore(is_master=True, port=0)
    results = {}

    def waiter():
        c = runtime.TCPStore(port=master.port)
        results["v"] = c.get("late_key")  # blocks until set
        c.close()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    master.set("late_key", b"arrived")
    t.join(timeout=5)
    assert not t.is_alive() and results["v"] == b"arrived"

    def member():
        c = runtime.TCPStore(port=master.port)
        c.barrier("b0", 3)
        c.close()

    ts = [threading.Thread(target=member) for _ in range(2)]
    for t in ts:
        t.start()
    master.barrier("b0", 3)
    for t in ts:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in ts)
    master.close()


RACER = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, {root!r})
    from paddle_tpu_torch.utils.cpp_extension import _build_shared
    out, log = sys.argv[1], sys.argv[2]

    def command(tmp):
        # a slow "compiler": writes the target in two parts, logging its run
        return [sys.executable, "-c",
                "import sys, time; open(sys.argv[2], 'a').write('x');"
                "f = open(sys.argv[1], 'w'); f.write('half');"
                "f.flush(); time.sleep(0.5); f.write(' whole'); f.close()",
                tmp, log]

    path = _build_shared(out, command)
    print(open(path).read())
""")


def test_concurrent_builds_run_the_compiler_once(tmp_path):
    """Six processes start one build together: one runs the command under
    the lock, into a name of its own, renamed into place; the others wait
    and read the whole file; no temporary name is left."""
    script = tmp_path / "racer.py"
    script.write_text(RACER.format(root=ROOT))
    out, log = tmp_path / "lib.so", tmp_path / "runs.log"
    procs = [subprocess.Popen([sys.executable, str(script), str(out),
                               str(log)], stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0] * 6
    assert outs == ["half whole"] * 6
    assert log.read_text() == "x"
    assert sorted(os.listdir(tmp_path)) == ["lib.so", "lib.so.lock",
                                            "racer.py", "runs.log"]


def test_failed_build_raises_with_the_compilers_output(tmp_path):
    out = str(tmp_path / "bad.so")
    with pytest.raises(RuntimeError, match="exit 3"):
        cpp_extension._build_shared(out, lambda tmp: [
            sys.executable, "-c", "import sys; print('no'); sys.exit(3)"])
    assert not os.path.exists(out)
    assert os.listdir(tmp_path) == ["bad.so.lock"]
    with pytest.raises(RuntimeError, match="not found"):
        cpp_extension._build_shared(out, lambda tmp: ["no-such-compiler"])


def test_shm_ring_round_trip():
    name = f"/pt_test_ring_{os.getpid()}"
    ring = runtime.ShmRing(name, slot_size=1 << 12, n_slots=4)
    peer = runtime.ShmRing(name, create=False)
    try:
        assert peer.slot_size == 1 << 12
        assert ring.pop(timeout_ms=0) is None
        for i in range(3):
            assert peer.push(bytes([i]) * (100 + i))
        assert len(ring) == 3
        assert [ring.pop() for _ in range(3)] == [
            bytes([i]) * (100 + i) for i in range(3)]
        with pytest.raises(ValueError, match="slot size"):
            peer.push(b"x" * (1 << 12))
    finally:
        peer.close()
        ring.close()


# ---------------------------------------------------- the native ring

class _Rows:
    def __len__(self):
        return 24

    def __getitem__(self, i):
        return np.full((4,), float(i), np.float32)


def _batches(dl):
    out = [np.asarray(b) for b in dl]
    dl._shutdown_workers()
    return out


def test_native_ring_transport_round_trips():
    """use_native_ring=True: the same batches, in the same order, as the
    JAX package's loader and the port's queue transport."""
    from paddle_tpu.io.dataloader import DataLoader as JaxLoader
    from paddle_tpu_torch.io import DataLoader
    got = _batches(DataLoader(_Rows(), batch_size=4, num_workers=2,
                              use_native_ring=True))
    queue = _batches(DataLoader(_Rows(), batch_size=4, num_workers=2))
    want = _batches(JaxLoader(_Rows(), batch_size=4, num_workers=2))
    assert len(got) == 6
    for k, (g, q, w) in enumerate(zip(got, queue, want)):
        assert np.array_equal(g, w) and np.array_equal(g, q), k
        assert np.array_equal(g, np.stack(
            [np.full((4,), float(4 * k + j), np.float32) for j in range(4)]))


def test_native_ring_oversized_batch_falls_back_to_shm_refs():
    """A batch bigger than the ring slot parks its arrays in their own shm
    segments and sends light refs through the ring."""
    from paddle_tpu_torch.io import DataLoader

    class BigDS:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.full((1 << 18,), float(i), np.float32)  # 1 MB each

    got = _batches(DataLoader(BigDS(), batch_size=2, num_workers=1,
                              use_native_ring=True, ring_slot_mb=1))
    assert len(got) == 2 and got[0].shape == (2, 1 << 18)
    assert (got[0][0] == 0.0).all() and (got[1][1] == 3.0).all()


def test_native_ring_object_heavy_batch_reports_instead_of_dying():
    """A batch that cannot shrink below the slot (no big arrays) raises
    naming the ring slot; the worker survives to be shut down."""
    from paddle_tpu_torch.io import DataLoader

    class ObjDS:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return ["x" * 500_000]

    dl = DataLoader(ObjDS(), batch_size=2, num_workers=1,
                    use_native_ring=True, ring_slot_mb=0,
                    collate_fn=lambda items: sum(items, []))
    dl.ring_slot = 4096
    with pytest.raises(RuntimeError, match="ring slot"):
        list(dl)
    dl._shutdown_workers()

"""The port's wire transport (``paddle_tpu_torch.inference.transport``)
against the JAX package's, on the CPU.

The 31 cases of ``tests/test_transport.py`` run on both packages (the
``side`` parameter): frame layout and order, the frame cap both ways,
typed error marshalling by name, snapshot transit, the ``net.*`` chaos
classes and the frame-corruption fuzz contract, binary page frames.
Then the two packages against each other over one ``socketpair``, in
both directions: the same message makes the same bytes on the wire, and
each end reads what the other wrote, page frames included. Last, the
frame cap's edge: one Llama-2-7B bf16 page frame (``[2, 32, 16, 32,
128]`` ``uint16``, 8,388,608 bytes) passes on both packages, one byte
more raises ``FrameError`` before anything is sent.
"""
import json
import random
import socket
import struct
import threading
import types

import numpy as np
import pytest
import torch

import paddle_tpu.reliability as JR
import paddle_tpu_torch.reliability as TR
from paddle_tpu.inference import transport as jax_transport
from paddle_tpu.telemetry import MetricRegistry as JaxRegistry
from paddle_tpu.telemetry.exposition import merge_snapshots as jax_merge
from paddle_tpu_torch.inference import transport as torch_transport
from paddle_tpu_torch.telemetry import MetricRegistry as TorchRegistry
from paddle_tpu_torch.telemetry.exposition import \
    merge_snapshots as torch_merge

pytestmark = pytest.mark.net

SIDES = {
    "jax": types.SimpleNamespace(T=jax_transport, R=JR, E=JR.errors,
                                 F=JR.faults, Registry=JaxRegistry,
                                 merge=jax_merge),
    "port": types.SimpleNamespace(T=torch_transport, R=TR, E=TR.errors,
                                  F=TR.faults, Registry=TorchRegistry,
                                  merge=torch_merge),
}


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


def _pair(s, fault_injector=None, registry=None):
    a, b = socket.socketpair()
    return (s.T.Connection(a, fault_injector=fault_injector,
                           registry=registry, peer="a"),
            s.T.Connection(b, peer="b"))


class TestFraming:
    def test_roundtrip_and_order(self, side):
        a, b = _pair(side)
        for i in range(5):
            a.send({"i": i, "payload": "x" * (i * 100)})
        got = [b.recv(timeout=2)["i"] for i in range(5)]
        assert got == list(range(5))
        a.close()
        b.close()

    def test_large_frame_roundtrips(self, side):
        a, b = _pair(side)
        msg = {"blob": "y" * 300_000}
        got = {}

        def rx():               # a frame bigger than the kernel buffer
            got["msg"] = b.recv(timeout=10)   # needs a live reader

        th = threading.Thread(target=rx)
        th.start()
        a.send(msg)
        th.join(10)
        assert got.get("msg") == msg

    def test_timeout_is_plain_timeout(self, side):
        a, b = _pair(side)
        with pytest.raises(TimeoutError):
            b.recv(timeout=0.05)
        a.send({"late": 1})          # connection still fine afterwards
        assert b.recv(timeout=2) == {"late": 1}

    def test_oversize_outbound_refused_without_desync(self, side):
        a, b = _pair(side)
        with pytest.raises(side.E.FrameError):
            a.send({"blob": "z" * (side.T.MAX_FRAME + 1)})
        a.send({"ok": 1})            # nothing hit the wire: still live
        assert b.recv(timeout=2) == {"ok": 1}

    def test_oversize_inbound_severs(self, side):
        raw_a, raw_b = socket.socketpair()
        b = side.T.Connection(raw_b, peer="b")
        raw_a.sendall(struct.pack("!I", side.T.MAX_FRAME + 1) + b"x" * 16)
        with pytest.raises(side.E.TransportError):
            b.recv(timeout=2)
        assert b.closed

    def test_peer_close_is_transport_error(self, side):
        a, b = _pair(side)
        a.close()
        with pytest.raises(side.E.TransportError):
            b.recv(timeout=2)

    def test_garbage_payload_is_frame_error_stream_survives(self, side):
        raw_a, raw_b = socket.socketpair()
        b = side.T.Connection(raw_b, peer="b")
        rng = random.Random(7)
        for _ in range(5):
            junk = bytes(rng.randrange(256) for _ in range(40))
            raw_a.sendall(struct.pack("!I", len(junk)) + junk)
            with pytest.raises(side.E.FrameError):
                b.recv(timeout=2)
        ok = json.dumps({"fine": True}).encode()
        raw_a.sendall(struct.pack("!I", len(ok)) + ok)
        assert b.recv(timeout=2) == {"fine": True}

    def test_truncated_frame_then_eof_severs(self, side):
        raw_a, raw_b = socket.socketpair()
        b = side.T.Connection(raw_b, peer="b")
        raw_a.sendall(struct.pack("!I", 100) + b"{\"half\":")
        raw_a.close()
        with pytest.raises(side.E.TransportError):
            b.recv(timeout=2)


class TestErrorMarshalling:
    def test_reliability_family_roundtrips_by_type(self, side):
        for name in ("DeadlineExceeded", "QueueFullError",
                     "ServerClosed", "RequestCancelled",
                     "CircuitOpenError", "ReplicaLostError",
                     "TransportError", "FrameError"):
            cls = getattr(side.E, name)
            back = side.T.unmarshal_error(side.T.marshal_error(cls("boom")))
            assert type(back) is cls
            assert "boom" in str(back)

    def test_structured_ctor_degrades_to_typed_base(self, side):
        err = side.E.CallbackError([("r1", ValueError("bad"))])
        back = side.T.unmarshal_error(side.T.marshal_error(err))
        assert isinstance(back, side.E.ReliabilityError)
        assert "CallbackError" in str(back)

    def test_builtins_roundtrip(self, side):
        for exc in (TimeoutError("slow"), ValueError("nope"),
                    KeyError("missing")):
            back = side.T.unmarshal_error(side.T.marshal_error(exc))
            assert type(back) is type(exc)

    def test_unknown_kind_becomes_tagged_runtimeerror(self, side):
        back = side.T.unmarshal_error({"kind": "WeirdVendorError",
                                       "message": "huh"})
        assert type(back) is RuntimeError
        assert "WeirdVendorError" in str(back)

    def test_typed_deadline_survives_isinstance_contracts(self, side):
        back = side.T.unmarshal_error(
            side.T.marshal_error(side.E.DeadlineExceeded("late")))
        assert isinstance(back, TimeoutError)
        assert isinstance(back, side.E.ReliabilityError)
        assert not isinstance(back, side.E.QueueFullError)


class TestJsonTransit:
    def test_jsonable_numpy_and_sets(self, side):
        out = side.T.jsonable({"a": np.int32(3), "b": np.arange(3),
                               "c": frozenset({2, 1}), "d": (1, "x"),
                               "e": None})
        assert out == {"a": 3, "b": [0, 1, 2], "c": [1, 2],
                       "d": [1, "x"], "e": None}
        json.dumps(out)

    def test_snapshot_roundtrip_and_fleet_merge(self, side):
        reg = side.Registry()
        reg.counter("c_total", "c", labelnames=("k",)) \
           .labels(k="x").inc(3)
        reg.gauge("g", "g").set(7)
        reg.histogram("h_seconds", "h").observe(0.02)
        snap = reg.snapshot()
        back = side.T.decode_snapshot(json.loads(json.dumps(
            side.T.encode_snapshot(snap))))
        assert back["c_total"]["samples"][("x",)] == 3
        assert back["g"]["samples"][()] == 7
        assert back["h_seconds"]["samples"][()]["count"] == 1
        merged = side.merge([snap, back])
        assert merged["c_total"]["samples"][("x",)] == 6


class TestNetChaos:
    def test_drop_on_send_loses_frame_connection_lives(self, side):
        fi = side.R.FaultInjector(seed=3).on(
            side.F.NET_SEND, schedule=[0], error=side.T.NetDrop)
        a, b = _pair(side, fault_injector=fi)
        assert a.send({"n": 0}) is False
        assert a.send({"n": 1}) is True
        assert b.recv(timeout=2) == {"n": 1}
        assert fi.fired(side.F.NET_SEND) == 1

    def test_delay_on_send_delivers_late(self, side):
        fi = side.R.FaultInjector(seed=3).on(
            side.F.NET_SEND, schedule=[0], error=side.T.NetDelay)
        a, b = _pair(side, fault_injector=fi)
        assert a.send({"n": 0}) is True
        assert b.recv(timeout=2) == {"n": 0}

    def test_truncate_on_send_severs_both_ends(self, side):
        fi = side.R.FaultInjector(seed=3).on(
            side.F.NET_SEND, schedule=[1], error=side.T.NetTruncate)
        a, b = _pair(side, fault_injector=fi)
        a.send({"n": 0})
        with pytest.raises(side.E.TransportError):
            a.send({"n": 1})
        assert a.closed
        assert b.recv(timeout=2) == {"n": 0}
        with pytest.raises(side.E.TransportError):
            while True:
                b.recv(timeout=2)

    def test_sever_on_recv(self, side):
        fi = side.R.FaultInjector(seed=3).on(
            side.F.NET_RECV, schedule=[0], error=side.T.NetSever)
        a, b = _pair(side)
        b._faults = fi
        a.send({"n": 0})
        with pytest.raises(side.E.TransportError):
            b.recv(timeout=2)
        assert b.closed

    def test_drop_on_recv_discards_one_frame(self, side):
        fi = side.R.FaultInjector(seed=3).on(
            side.F.NET_RECV, schedule=[0], error=side.T.NetDrop)
        a, b = _pair(side)
        b._faults = fi
        a.send({"n": 0})
        a.send({"n": 1})
        assert b.recv(timeout=2) == {"n": 1}

    def test_partition_checked_on_both_directions(self, side):
        fi = side.R.FaultInjector(seed=3).on(side.F.NET_PARTITION,
                                             schedule=[0])
        a, b = _pair(side, fault_injector=fi)
        with pytest.raises(side.E.TransportError):
            a.send({"n": 0})
        fi2 = side.R.FaultInjector(seed=3).on(side.F.NET_PARTITION,
                                              schedule=[0])
        c, d = _pair(side)
        d._faults = fi2
        c.send({"n": 0})
        with pytest.raises(side.E.TransportError):
            d.recv(timeout=2)

    def test_connect_fault_refuses_typed(self, side):
        lst = socket.create_server(("127.0.0.1", 0))
        try:
            addr = lst.getsockname()
            fi = side.R.FaultInjector(seed=3).on(side.F.NET_CONNECT,
                                                 schedule=[0])
            with pytest.raises(side.E.TransportError):
                side.T.connect(addr, timeout=2, fault_injector=fi)
        finally:
            lst.close()

    @pytest.mark.chaos
    def test_same_seed_same_injection_trace(self, side):
        def run(seed):
            fi = side.R.FaultInjector(seed=seed) \
                .on(side.F.NET_SEND, probability=0.3,
                    error=side.T.NetDrop) \
                .on(side.F.NET_RECV, probability=0.2,
                    error=side.T.NetDrop)
            a, b = _pair(side, fault_injector=fi)
            b._faults = fi
            delivered = []
            for i in range(30):
                a.send({"i": i})
            a.close()
            while True:
                try:
                    delivered.append(b.recv(timeout=2)["i"])
                except side.E.TransportError:
                    break
            return list(fi.trace), delivered

        t1, d1 = run(11)
        t2, d2 = run(11)
        t3, _ = run(12)
        assert t1 == t2 and d1 == d2
        assert t1 != t3
        assert len(d1) < 30


class TestFuzzOneCallFails:
    def test_receiver_loop_survives_seeded_garbage_storm(self, side):
        raw_a, raw_b = socket.socketpair()
        b = side.T.Connection(raw_b, peer="b")
        rng = random.Random(1234)
        good, bad = 0, 0
        for i in range(40):
            if rng.random() < 0.5:
                junk = bytes(rng.randrange(256)
                             for _ in range(rng.randrange(1, 80)))
                raw_a.sendall(struct.pack("!I", len(junk)) + junk)
            else:
                ok = json.dumps({"i": i}).encode()
                raw_a.sendall(struct.pack("!I", len(ok)) + ok)
        raw_a.close()
        while True:
            try:
                b.recv(timeout=2)
            except side.E.FrameError:
                bad += 1
                continue
            except side.E.TransportError:
                break
            good += 1
        assert good > 0 and bad > 0

    def test_truncate_fails_one_call_not_the_waiter(self, side):
        fi = side.R.FaultInjector(seed=9).on(
            side.F.NET_SEND, schedule=[2], error=side.T.NetTruncate)
        a, _b = _pair(side, fault_injector=fi)
        a.send({"n": 0})
        a.send({"n": 1})
        t0 = threading.Event()

        def doomed():
            with pytest.raises(side.E.TransportError):
                a.send({"n": 2})
            t0.set()

        th = threading.Thread(target=doomed)
        th.start()
        th.join(5)
        assert t0.is_set()


class TestPageFrames:
    def test_page_frame_roundtrip_bitexact(self, side):
        a, b = _pair(side)
        page = np.arange(2 * 3 * 8 * 4 * 4, dtype=np.float32) \
            .reshape(2, 3, 8, 4, 4)
        assert a.send_pages({"push": "pages", "i": 0, "n": 1,
                             "shape": list(page.shape),
                             "dtype": str(page.dtype)},
                            page.tobytes()) is True
        msg = b.recv(timeout=2)
        assert msg["push"] == "pages"
        back = np.frombuffer(msg["_payload"],
                             dtype=np.dtype(msg["dtype"])) \
            .reshape(msg["shape"])
        np.testing.assert_array_equal(back, page)
        a.close()
        b.close()

    def test_oversized_page_frame_fails_typed_never_hangs(self, side):
        raw_a, raw_b = socket.socketpair()
        a = side.T.Connection(raw_a, peer="a", max_frame_bytes=4096)
        b = side.T.Connection(raw_b, peer="b", max_frame_bytes=4096)
        with pytest.raises(side.E.FrameError):
            a.send_pages({"push": "pages", "i": 0}, b"\x00" * 5000)
        assert a.send({"ok": 1}) is True
        assert b.recv(timeout=2) == {"ok": 1}
        small = np.ones(16, dtype=np.float32)
        a.send_pages({"push": "pages", "i": 0, "shape": [16],
                      "dtype": "float32"}, small.tobytes())
        msg = b.recv(timeout=2)
        np.testing.assert_array_equal(
            np.frombuffer(msg["_payload"], dtype=np.float32), small)
        a.close()
        b.close()

    def test_max_frame_bytes_parameterized_per_connection(self, side):
        big = b"\x01" * (64 * 1024)
        raw_a, raw_b = socket.socketpair()
        small_a = side.T.Connection(raw_a, peer="a", max_frame_bytes=1024)
        small_b = side.T.Connection(raw_b, peer="b", max_frame_bytes=1024)
        with pytest.raises(side.E.FrameError):
            small_a.send_pages({"i": 0}, big)
        small_a.close()
        small_b.close()
        raw_c, raw_d = socket.socketpair()
        wide_c = side.T.Connection(raw_c, peer="c",
                                   max_frame_bytes=1024 * 1024)
        wide_d = side.T.Connection(raw_d, peer="d",
                                   max_frame_bytes=1024 * 1024)
        assert wide_c.send_pages({"i": 0}, big) is True
        msg = wide_d.recv(timeout=5)
        assert msg["_payload"] == big
        wide_c.close()
        wide_d.close()

    def test_connect_accepts_max_frame_bytes(self, side):
        lst = socket.create_server(("127.0.0.1", 0))
        try:
            conn = side.T.connect(lst.getsockname(), timeout=2,
                                  max_frame_bytes=123456)
            assert conn.max_frame_bytes == 123456
            conn.close()
        finally:
            lst.close()

    def test_sha256_mismatch_spoils_one_transfer_only(self, side):
        raw_a, raw_b = socket.socketpair()
        b = side.T.Connection(raw_b, peer="b")
        blob = b"\x07" * 64
        head = {"push": "pages", "i": 0, "_bin": len(blob),
                "_sha256": "0" * 64}
        hb = json.dumps(head, separators=(",", ":")).encode()
        raw_a.sendall(struct.pack("!I", len(hb)) + hb + blob)
        with pytest.raises(side.E.FrameError):
            b.recv(timeout=2)
        ok = json.dumps({"fine": 1}).encode()
        raw_a.sendall(struct.pack("!I", len(ok)) + ok)
        assert b.recv(timeout=2) == {"fine": 1}
        b.close()

    def test_page_send_chaos_point_targets_only_page_frames(self, side):
        fi = side.R.FaultInjector(seed=4).on(
            side.F.NET_PAGE_SEND, schedule=[0], error=side.T.NetDrop)
        a, b = _pair(side, fault_injector=fi)
        assert a.send_pages({"i": 0}, b"\x02" * 32) is False
        assert a.send({"ctl": 1}) is True
        assert b.recv(timeout=2) == {"ctl": 1}
        assert fi.fired(side.F.NET_PAGE_SEND) == 1
        a.close()
        b.close()


# ------------------------------------------------ the two packages on one wire

MESSAGES = [
    {"id": 7, "op": "submit", "ids": [3, 1, 4], "n": 8, "seed": None,
     "deadline_s": 1.5, "priority": 0, "tid": "r3", "where": "replica1"},
    {"re": 7, "ok": True, "r": {"rid": 0, "seed": 31}},
    {"re": 9, "ok": False, "err": {"kind": "DeadlineExceeded",
                                   "message": "late é"}},
    {"push": "digest", "d": {"seq": 4, "queue_depth": 2, "in_flight": 1,
                             "health": "healthy", "sketch": [17, -3],
                             "stats": {"a": 1.25}, "util": {}}},
    {"push": "tokens", "rid": 3, "off": 2, "toks": [9, 0, 15]},
]


def _raw(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "stream ended early"
        buf += chunk
    return buf


def _capture(s, send):
    """The bytes a ``send`` on side ``s``'s Connection puts on the wire."""
    a, raw = socket.socketpair()
    conn = s.T.Connection(a, peer="a")
    try:
        send(conn)
        (n,) = struct.unpack("!I", _raw(raw, 4))
        head = _raw(raw, n)
        body = json.loads(head)
        blob = _raw(raw, body["_bin"]) if "_bin" in body else b""
        return struct.pack("!I", n) + head + blob
    finally:
        conn.close()
        raw.close()


@pytest.mark.parametrize("msg", MESSAGES,
                         ids=["submit", "reply", "error", "digest",
                              "tokens"])
def test_same_message_same_bytes(msg):
    want = _capture(SIDES["jax"], lambda c: c.send(msg))
    got = _capture(SIDES["port"], lambda c: c.send(msg))
    assert got == want


def test_same_page_frame_same_bytes():
    page = np.arange(2 * 2 * 8 * 2 * 4, dtype=np.float32) \
        .reshape(2, 2, 8, 2, 4)
    head = {"push": "pages", "xid": "x3", "i": 0, "n": 1,
            "shape": list(page.shape), "dtype": str(page.dtype)}

    def send(c):
        c.send_pages(head, page.tobytes())

    assert _capture(SIDES["port"], send) == _capture(SIDES["jax"], send)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_cross_framework_connection(writer, reader):
    """A JAX ``Connection`` and a port ``Connection`` on the two ends of
    one ``socketpair``: control frames, a binary page frame and a typed
    error cross in both directions."""
    W, R_ = SIDES[writer], SIDES[reader]
    a, b = socket.socketpair()
    w = W.T.Connection(a, peer=writer)
    r = R_.T.Connection(b, peer=reader)
    try:
        for m in MESSAGES:
            assert w.send(m) is True
            assert r.recv(timeout=2) == m
            assert r.send(m) is True
            assert w.recv(timeout=2) == m
        page = np.arange(64, dtype=np.uint16).reshape(2, 1, 4, 2, 4)
        assert w.send_pages({"i": 0, "shape": list(page.shape),
                             "dtype": str(page.dtype)}, page.tobytes())
        msg = r.recv(timeout=2)
        np.testing.assert_array_equal(
            np.frombuffer(msg["_payload"], dtype=np.dtype(msg["dtype"]))
            .reshape(msg["shape"]), page)
        err = W.T.marshal_error(W.E.QueueFullError("shed"))
        w.send({"re": 1, "ok": False, "err": err})
        back = R_.T.unmarshal_error(r.recv(timeout=2)["err"])
        assert type(back) is R_.E.QueueFullError
    finally:
        w.close()
        r.close()


# ------------------------------------------------------- the frame cap's edge

PAGE_7B = (2, 32, 16, 32, 128)       # [k|v, layers, rows, kv heads, dim]


def test_max_frame_is_the_reference_constant():
    assert torch_transport.MAX_FRAME == jax_transport.MAX_FRAME \
        == 8 * 1024 * 1024


@pytest.mark.parametrize("name", sorted(SIDES))
def test_7b_bf16_page_frame_sits_on_the_cap(name):
    """One Llama-2-7B bf16 page (``uint16`` bit patterns) is exactly
    ``MAX_FRAME`` bytes and crosses; one byte more is refused with
    ``FrameError`` before any byte reaches the socket, and the
    connection keeps serving."""
    s = SIDES[name]
    page = torch.arange(int(np.prod(PAGE_7B)), dtype=torch.int32) \
        .to(torch.bfloat16).reshape(PAGE_7B).view(torch.uint16).numpy()
    blob = page.tobytes()
    assert len(blob) == 8_388_608 == s.T.MAX_FRAME
    a, b = _pair(s)
    got = {}

    def rx():
        got["msg"] = b.recv(timeout=30)

    th = threading.Thread(target=rx)
    th.start()
    assert a.send_pages({"i": 0, "shape": list(page.shape),
                         "dtype": str(page.dtype)}, blob) is True
    th.join(30)
    msg = got["msg"]
    assert msg["dtype"] == "uint16"
    np.testing.assert_array_equal(
        np.frombuffer(msg["_payload"], dtype=np.uint16).reshape(PAGE_7B),
        page)
    with pytest.raises(s.E.FrameError):
        a.send_pages({"i": 1}, blob + b"\x00")
    assert a.send({"after": 1}) is True
    assert b.recv(timeout=2) == {"after": 1}
    a.close()
    b.close()


def test_jsonable_torch_values_are_the_references_json():
    """Torch scalars, tensors, dtypes and devices flatten to the JSON
    types the reference gives the same values (numbers, lists, names)."""
    out = torch_transport.jsonable({
        "i": torch.tensor(3), "f": torch.tensor(0.5),
        "h": torch.tensor(1.5, dtype=torch.bfloat16),
        "t": torch.arange(3, dtype=torch.int32),
        "dt": torch.bfloat16, "dev": torch.device("cpu"),
        "np": np.float32(0.25)})
    assert out == {"i": 3, "f": 0.5, "h": 1.5, "t": [0, 1, 2],
                   "dt": "bfloat16", "dev": "cpu", "np": 0.25}
    ref = jax_transport.jsonable({"i": np.int64(3), "f": np.float32(0.5),
                                  "t": np.arange(3, dtype=np.int32),
                                  "np": np.float32(0.25)})
    assert json.dumps({k: out[k] for k in ref}) == json.dumps(ref)

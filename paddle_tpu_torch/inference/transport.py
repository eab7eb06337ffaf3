"""Typed length-prefixed RPC framing for the process-isolated fleet: a
thin typed control plane over TCP between a router and its replica
processes (``inference.remote``).

Copied from ``paddle_tpu/inference/transport.py`` (stdlib only). The
protocol is the reference's byte for byte — the same frame layout, the
same ``json.dumps`` separators and key order, the same frame cap — so a
router of either package talks to a replica host of the other.

Frame layout (the whole protocol)::

    +----------------+----------------------------------------+
    | length: 4 bytes| payload: <length> bytes of UTF-8 JSON  |
    | big-endian u32 | (one JSON object per frame)            |
    +----------------+----------------------------------------+

One frame is one message. A length above the connection's frame cap
(``max_frame_bytes``, default ``MAX_FRAME``) or a stream that ends
mid-frame means the byte stream can no longer be trusted and the
connection is closed; a payload that is not a JSON object spoils only
ITSELF — framing stayed in sync, so the receiver drops the frame and
keeps serving (the frame-corruption fuzz suite pins both behaviours).

BINARY page frames (live KV-page migration): float arrays
must not round-trip through JSON, so ``send_pages(header, payload)``
emits one ordinary JSON header frame — the caller's dict plus
``_bin`` (raw byte count) and ``_sha256`` (payload digest) — followed
by exactly ``_bin`` raw bytes on the same stream::

    +--------+---------------------+---------------------------+
    | length | header JSON (+_bin, | raw payload: <_bin> bytes |
    | u32    |  +_sha256)          | (page bytes, no encoding) |
    +--------+---------------------+---------------------------+

``recv`` reads the payload unconditionally (any consumer keeps the
stream in sync) and verifies the digest: a mismatch raises
``FrameError`` AFTER the bytes were consumed — only that transfer is
spoiled, the connection keeps serving, and the migration layer above
degrades to replay. An oversized payload fails typed (``FrameError``)
BEFORE anything hits the wire; senders chunk page groups under the
cap instead.

Typed errors cross the wire by NAME: ``marshal_error`` flattens any
exception to ``{"kind", "message"}`` and ``unmarshal_error`` rebuilds
the matching ``reliability.ReliabilityError`` subclass (or builtin
exception) on the caller's side, so a remote ``DeadlineExceeded`` is
still a ``DeadlineExceeded`` to the client that branches on type.

Chaos (reliability.faults): ``Connection`` checks ``net.send`` /
``net.recv`` on every frame and ``net.partition`` on both directions.
The armed error CLASS picks the failure mode — ``NetDrop`` (the frame
vanishes; the sender believes it was sent, the receiver never sees
it), ``NetDelay`` (late delivery), ``NetTruncate`` (a partial frame,
then a hard close — the peer sees a corrupt stream), ``NetSever`` or
a plain ``InjectedFault`` (connection cut). Fires draw from the same
seeded per-point PRNG streams as every other chaos point, so a
partition storm replays exactly.

The cap is a protocol constant: ``MAX_FRAME`` is 8 MiB and a payload
is refused only when it is LONGER. One Llama-2-7B page frame of a bf16
pool (``[2, 32 layers, 16 rows, 32 kv heads, 128]`` as ``uint16`` bit
patterns) is exactly 8,388,608 bytes and passes; an f32 7B page is
twice that and fails typed before any byte is sent, so that move
degrades to replay.

Everything here is stdlib-only and import-light: a spawned replica
host loads the wire layer before it pays for torch and CUDA.
"""
import builtins
import hashlib
import json
import select
import socket
import struct
import threading
import time

from ..reliability import errors as _errors
from ..reliability import faults
from ..reliability.errors import (FrameError, InjectedFault,
                                  ReliabilityError, TransportError)

__all__ = ["Connection", "connect", "MAX_FRAME", "NetDrop", "NetDelay",
           "NetTruncate", "NetSever", "marshal_error", "unmarshal_error",
           "encode_snapshot", "decode_snapshot", "jsonable"]

# one frame must hold a full registry snapshot or postmortem bundle,
# never an attacker-sized allocation: past this the stream is closed.
# The DEFAULT cap — a Connection carrying big page groups raises its
# own ``max_frame_bytes`` instead of loosening every peer's guard.
MAX_FRAME = 8 * 1024 * 1024
_LEN = struct.Struct("!I")


# --------------------------------------------------------- chaos modes
class NetDrop(InjectedFault):
    """The frame vanishes in flight: a send returns as if delivered, a
    recv consumes and discards one inbound frame. The affected CALL
    times out at its deadline — the connection survives."""


class NetDelay(InjectedFault):
    """The frame is delivered late (``SECONDS``). Models congestion:
    deadlines keep charging while the wire dawdles."""

    SECONDS = 0.02


class NetTruncate(InjectedFault):
    """Only a prefix of the frame reaches the wire, then the socket
    hard-closes: the peer observes a mid-frame EOF (stream desync) and
    tears the connection down."""


class NetSever(InjectedFault):
    """The connection is cut outright — also the effect of a plain
    ``InjectedFault`` at any ``net.*`` point, and of ``net.partition``
    whichever direction traffic was flowing."""


# ----------------------------------------------------- error marshalling
def marshal_error(exc):
    """Flatten ``exc`` to a wire dict: ``{"kind": type name,
    "message": str}``. The TYPE is the contract (clients branch on the
    ``ReliabilityError`` family), the message is for humans."""
    return {"kind": type(exc).__name__, "message": str(exc)}


def unmarshal_error(d):
    """Rebuild a marshalled error as the most faithful local type: the
    named ``reliability.errors`` class when it exists (the whole typed
    family crosses the wire), a builtin exception otherwise
    (``TimeoutError``, ``ValueError``, ...), else a ``RuntimeError``
    tagged with the foreign kind — never a silent downgrade to str."""
    kind = str(d.get("kind", "RuntimeError"))
    msg = str(d.get("message", ""))
    cls = getattr(_errors, kind, None)
    if isinstance(cls, type) and issubclass(cls, ReliabilityError):
        try:
            err = cls(msg)
        except Exception:
            # a family member whose constructor cannot rebuild from a
            # bare message (CallbackError's error list) degrades to
            # the typed BASE, keeping the family contract for catchers
            return ReliabilityError(f"{kind}: {msg}")
        if isinstance(err, _errors.CallbackError):
            # a short message can unpack as a bogus (rid, error) pair;
            # never hand that half-built object to a caller
            return ReliabilityError(f"{kind}: {msg}")
        return err
    cls = getattr(builtins, kind, None)
    if isinstance(cls, type) and issubclass(cls, Exception):
        try:
            return cls(msg)
        except TypeError:
            pass
    return RuntimeError(f"remote {kind}: {msg}")


# ------------------------------------------------------- JSON adapters
def jsonable(x):
    """Best-effort conversion of host-side structures (numpy and torch
    scalars / arrays, tuples, frozensets, postmortem bundles) into plain
    JSON values — the reference's for the same values: a torch scalar
    is its Python number, a tensor its nested list, a torch dtype its
    name as numpy spells it (``"bfloat16"``), a device its string
    (``"cuda:0"``). A CUDA tensor is read back to the host, so callers
    on a serving path hand this host values only. Unknown objects
    degrade to ``repr`` — a debug payload must cross the wire lossy
    rather than fail the call that carries it."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if type(x).__module__ == "torch" \
            and type(x).__name__ in ("dtype", "device"):
        return str(x).removeprefix("torch.")
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, (set, frozenset)):
        # mixed-type sets do not order; repr-keyed sort keeps the
        # degrade-lossy promise instead of raising out of a digest
        return sorted((jsonable(v) for v in x), key=repr)
    item = getattr(x, "item", None)
    if callable(item) and getattr(x, "ndim", None) == 0:
        return x.item()                      # numpy scalar
    tolist = getattr(x, "tolist", None)
    if callable(tolist):
        return tolist()                      # numpy array
    return repr(x)


def encode_snapshot(snap):
    """A ``MetricRegistry.snapshot()`` re-keyed for JSON transit: the
    tuple-keyed ``samples`` maps become ``[[key...], value]`` pairs.
    ``decode_snapshot`` is the exact inverse, so a remote replica's
    snapshot merges into ``fleet_snapshot()`` like a local one."""
    out = {}
    for name, m in snap.items():
        out[name] = {"kind": m["kind"], "help": m["help"],
                     "labelnames": list(m["labelnames"]),
                     "samples": [[list(k), _encode_sample(v)]
                                 for k, v in m["samples"].items()]}
    return out


def _encode_sample(v):
    if isinstance(v, dict):                  # histogram child
        return {"buckets": [[le, c] for le, c in v["buckets"]],
                "sum": v["sum"], "count": v["count"]}
    return v


def decode_snapshot(snap):
    """Inverse of ``encode_snapshot`` (returns the registry-snapshot
    shape ``merge_snapshots`` consumes)."""
    out = {}
    for name, m in snap.items():
        samples = {}
        for key, v in m["samples"]:
            if isinstance(v, dict):
                v = {"buckets": [(le, c) for le, c in v["buckets"]],
                     "sum": v["sum"], "count": v["count"]}
            samples[tuple(key)] = v
        out[name] = {"kind": m["kind"], "help": m["help"],
                     "labelnames": tuple(m["labelnames"]),
                     "samples": samples}
    return out


# ---------------------------------------------------------- connection
class Connection:
    """One framed, chaos-instrumented TCP connection.

    ``send(obj)`` frames one JSON object (thread-safe; returns False
    when an injected ``NetDrop`` swallowed the frame). ``recv(timeout)``
    returns the next inbound object, raising ``TimeoutError`` when
    nothing arrives in time, ``FrameError`` for a corrupt-but-resynced
    frame (the caller may keep reading), and ``TransportError`` once
    the connection is unusable (EOF, desync, sever). ``close()`` is
    idempotent and safe from any thread.

    ``registry`` (``telemetry.MetricRegistry``) publishes
    ``net_frames_total{dir}`` / ``net_bytes_total{dir}`` /
    ``net_transport_errors_total``; with the default None the hot path
    pays one ``is None`` check per frame.

    ``max_frame_bytes`` caps BOTH directions and both frame kinds
    (JSON payloads and binary page payloads): an outbound oversize
    fails typed (``FrameError``) before any bytes hit the wire, an
    inbound oversize is a desynced stream. Both peers of a page-
    migrating link must agree on the raised cap.
    """

    def __init__(self, sock, fault_injector=None, registry=None,
                 peer="", max_frame_bytes=MAX_FRAME):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass    # AF_UNIX (tests' socketpair) has no Nagle to turn off
        self._sock = sock
        self._send_lock = threading.Lock()
        self._rbuf = bytearray()
        self._faults = fault_injector
        self.max_frame_bytes = int(max_frame_bytes)
        self.peer = peer or _peername(sock)
        self.closed = False
        self._c_frames = self._c_bytes = self._c_errors = None
        if registry is not None and getattr(registry, "enabled", False):
            self._c_frames = registry.counter(
                "net_frames_total",
                "Wire frames by direction (sent counts frames that "
                "reached the socket; an injected drop is not sent)",
                labelnames=("dir",))
            self._c_bytes = registry.counter(
                "net_bytes_total", "Wire payload bytes by direction",
                labelnames=("dir",))
            self._c_errors = registry.counter(
                "net_transport_errors_total",
                "Connections torn down by a transport failure "
                "(EOF, frame desync, injected sever)")

    # ------------------------------------------------------------ chaos
    def _chaos(self, point):
        """Run one ``net.*`` check (plus the partition point) and map a
        fire to its wire behaviour. Returns ``"drop"`` when the frame
        must vanish; may sleep (delay), close + raise (truncate /
        sever)."""
        fi = self._faults
        if fi is None:
            return None
        for pt in (faults.NET_PARTITION, point):
            try:
                fi.check(pt, peer=self.peer)
            except NetDrop:
                return "drop"
            except NetDelay as e:
                time.sleep(type(e).SECONDS)
            except NetTruncate as e:
                if point in (faults.NET_SEND, faults.NET_PAGE_SEND):
                    return ("truncate", e)
                self._fail(TransportError(
                    f"injected {pt} truncation severed {self.peer}"), e)
            except InjectedFault as e:      # NetSever or plain fault
                self._fail(TransportError(
                    f"injected {pt} severed connection to "
                    f"{self.peer}"), e)
        return None

    def _fail(self, err, cause=None):
        if self._c_errors is not None:
            self._c_errors.inc()
        self.close()
        if cause is not None:
            err.__cause__ = cause
        raise err

    # ------------------------------------------------------------- send
    def send(self, obj):
        """Frame and send one JSON object. Returns True when the frame
        reached the socket, False when an injected drop swallowed it.
        Raises ``TransportError`` once the connection is unusable."""
        if self.closed:
            raise TransportError(
                f"connection to {self.peer} is closed")
        payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
        if len(payload) > self.max_frame_bytes:
            raise FrameError(
                f"frame of {len(payload)} bytes exceeds max_frame_bytes "
                f"({self.max_frame_bytes}); refusing to desync the "
                f"stream")
        verdict = self._chaos(faults.NET_SEND)
        return self._send_frame(_LEN.pack(len(payload)) + payload,
                                len(payload), verdict, faults.NET_SEND)

    def send_pages(self, header, payload):
        """Frame one BINARY page frame: ``header`` (a JSON-able dict,
        augmented with ``_bin`` = payload byte count and ``_sha256`` =
        payload digest) as an ordinary JSON frame, then the raw
        ``payload`` bytes on the same stream — pool pages cross the
        wire without JSON-encoding float arrays. Chaos point is
        ``net.page_send`` (plus the partition point), so a storm can
        target migration traffic without touching control frames.
        Returns True/False like ``send``; an oversized payload or
        header raises ``FrameError`` BEFORE any bytes hit the wire
        (chunk the page group under ``max_frame_bytes`` instead)."""
        if self.closed:
            raise TransportError(
                f"connection to {self.peer} is closed")
        payload = bytes(payload)
        if len(payload) > self.max_frame_bytes:
            raise FrameError(
                f"binary page frame of {len(payload)} bytes exceeds "
                f"max_frame_bytes ({self.max_frame_bytes}); chunk the "
                f"page group instead of desyncing the stream")
        head = dict(header)
        head["_bin"] = len(payload)
        head["_sha256"] = hashlib.sha256(payload).hexdigest()
        hb = json.dumps(head, separators=(",", ":")).encode("utf-8")
        if len(hb) > self.max_frame_bytes:
            raise FrameError(
                f"page-frame header of {len(hb)} bytes exceeds "
                f"max_frame_bytes ({self.max_frame_bytes})")
        verdict = self._chaos(faults.NET_PAGE_SEND)
        return self._send_frame(_LEN.pack(len(hb)) + hb + payload,
                                len(hb) + len(payload), verdict,
                                faults.NET_PAGE_SEND)

    def _send_frame(self, frame, nbytes, verdict, point):
        """Common tail of send/send_pages: apply the chaos verdict and
        put ``frame`` on the wire."""
        if verdict == "drop":
            return False
        if isinstance(verdict, tuple):      # ("truncate", fault)
            with self._send_lock:
                try:
                    self._sock.sendall(frame[:max(1, len(frame) // 2)])
                except OSError:
                    pass                    # peer already gone: the
                #                             truncation outcome stands
            self._fail(TransportError(
                f"injected {point} truncation severed {self.peer}"),
                verdict[1])
        with self._send_lock:
            try:
                self._sock.sendall(frame)
            except OSError as e:
                self._fail(TransportError(
                    f"send to {self.peer} failed: {e}"), e)
        if self._c_frames is not None:
            self._c_frames.labels(dir="sent").inc()
            self._c_bytes.labels(dir="sent").inc(nbytes)
        return True

    # ------------------------------------------------------------- recv
    def recv(self, timeout=None):
        """Return the next inbound JSON object. ``TimeoutError`` when
        nothing arrives in ``timeout`` seconds; ``FrameError`` for one
        corrupt payload (stream still in sync — keep reading);
        ``TransportError`` when the connection is done for."""
        while True:
            verdict = self._chaos(faults.NET_RECV)
            obj = self._recv_frame(timeout)
            if verdict == "drop":
                continue                    # the frame never "arrived"
            if self._c_frames is not None:
                self._c_frames.labels(dir="recv").inc()
            return obj

    def _recv_frame(self, timeout):
        head = self._read_exact(_LEN.size, timeout)
        (n,) = _LEN.unpack(head)
        if n > self.max_frame_bytes:
            self._fail(TransportError(
                f"inbound frame claims {n} bytes (> max_frame_bytes "
                f"{self.max_frame_bytes}); stream from {self.peer} "
                f"desynced"))
        payload = self._read_exact(n, timeout)
        if self._c_bytes is not None:
            self._c_bytes.labels(dir="recv").inc(n)
        try:
            obj = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            # framing held (we read exactly n bytes) so only THIS
            # frame is spoiled; the connection keeps serving
            raise FrameError(
                f"corrupt {n}-byte frame from {self.peer}: {e}") from e
        nbin = obj.get("_bin") if isinstance(obj, dict) else None
        if nbin is None:
            return obj
        # binary page frame: the raw payload is consumed UNCONDITIONALLY
        # (whoever reads the stream keeps it in sync) and verified here;
        # a digest mismatch spoils only this transfer — framing held, so
        # the connection keeps serving and the migration layer above
        # degrades to replay
        nbin = int(nbin)
        if nbin > self.max_frame_bytes:
            self._fail(TransportError(
                f"binary page frame claims {nbin} payload bytes "
                f"(> max_frame_bytes {self.max_frame_bytes}); stream "
                f"from {self.peer} desynced"))
        blob = self._read_exact(nbin, timeout)
        if self._c_bytes is not None:
            self._c_bytes.labels(dir="recv").inc(nbin)
        if hashlib.sha256(blob).hexdigest() != obj.get("_sha256"):
            raise FrameError(
                f"binary page frame from {self.peer} failed its "
                f"sha256 check ({nbin} bytes)")
        obj["_payload"] = blob
        return obj

    def _read_exact(self, n, timeout):
        buf = self._rbuf
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while len(buf) < n:
            if self.closed:
                raise TransportError(
                    f"connection to {self.peer} is closed")
            # the recv deadline is waited out in select(), NOT via
            # settimeout: a socket-wide timeout would also govern a
            # concurrent sendall from another thread (send and recv
            # share the fd), turning a slow-draining peer into a
            # spurious connection teardown
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no frame from {self.peer} in {timeout}s")
                try:
                    ready, _, _ = select.select([self._sock], [], [],
                                                remaining)
                except (OSError, ValueError) as e:
                    # fd closed under us by another thread
                    self._fail(TransportError(
                        f"recv from {self.peer} failed: {e}"), e)
                if not ready:
                    raise TimeoutError(
                        f"no frame from {self.peer} in {timeout}s")
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                raise TimeoutError(
                    f"no frame from {self.peer} in {timeout}s") from None
            except OSError as e:
                self._fail(TransportError(
                    f"recv from {self.peer} failed: {e}"), e)
            if not chunk:
                partial = " mid-frame" if buf or n < _LEN.size else ""
                self._fail(TransportError(
                    f"connection to {self.peer} closed by peer"
                    f"{partial}"))
            buf.extend(chunk)
        out = bytes(buf[:n])
        del buf[:n]
        return out

    # ------------------------------------------------------------ close
    def close(self):
        if self.closed:
            return
        self.closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass        # already reset by the peer / never connected
        try:
            self._sock.close()
        except OSError:
            pass        # double-close race with a failing send/recv


def _peername(sock):
    try:
        host, port = sock.getpeername()[:2]
        return f"{host}:{port}"
    except OSError:
        return "<disconnected>"


def connect(address, timeout=5.0, fault_injector=None, registry=None,
            max_frame_bytes=MAX_FRAME):
    """Dial ``address`` (the ``net.connect`` chaos point) and return a
    ``Connection``. A fired fault or OS-level refusal raises
    ``TransportError``."""
    if fault_injector is not None:
        for pt in (faults.NET_PARTITION, faults.NET_CONNECT):
            try:
                fault_injector.check(pt, peer=str(address))
            except NetDelay as e:
                time.sleep(type(e).SECONDS)
            except InjectedFault as e:
                err = TransportError(
                    f"injected {pt} refused connect to {address}")
                err.__cause__ = e
                raise err
    try:
        sock = socket.create_connection(address, timeout=timeout)
    except OSError as e:
        raise TransportError(
            f"connect to {address} failed: {e}") from e
    sock.settimeout(None)
    return Connection(sock, fault_injector=fault_injector,
                      registry=registry,
                      peer=f"{address[0]}:{address[1]}",
                      max_frame_bytes=max_frame_bytes)

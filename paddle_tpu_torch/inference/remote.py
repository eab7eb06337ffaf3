"""Process-isolated replicas behind the typed wire transport.

Copied from ``paddle_tpu/inference/remote.py`` and adapted to the port:
the host serves the port's ``ContinuousBatchingServer`` (on the device
its factory names), page frames carry a bf16 pool's pages as their
``uint16`` bit patterns (numpy has no bfloat16; the state says
``"page_dtype": "bfloat16"``), and a spawned child sets nothing of JAX.
The protocol is the reference's, op for op and frame for frame, so a
router of either package drives a host of the other.

``ReplicaHost`` runs one ``ContinuousBatchingServer`` behind the
length-prefixed JSON protocol (inference/transport.py): submit /
wait / cancel / evacuate / stats / health / start / stop / kill over
request-reply frames, streamed tokens and journey events as push
frames, and a load DIGEST pushed on a heartbeat cadence.

``RemoteReplica`` is the client proxy implementing the exact surface
``ReplicaRouter`` consumes — so the router works UNCHANGED over any
mix of in-process server objects and remote processes:

- Routing reads stay LOCK-FREE: ``queue_depth`` / ``in_flight`` /
  ``preempt_pressure`` / ``prefix_sketch`` / ``health`` read the last
  pushed digest (plain attribute loads), never the wire. Staleness is
  the health signal: a digest older than ``draining_after_s`` reads
  ``draining`` (the router stops routing new traffic there), older
  than ``dead_after_s`` reads ``dead`` (the supervisor evacuates) —
  missed heartbeats ARE the failure detector, exactly the contract the
  in-process fleet only pretended to have.

- Every submitted request is MIRRORED client-side (prompt, budget,
  RESOLVED seed, absolute deadline, streamed tokens so far). When the
  host process actually dies (SIGKILL, not a polite ``kill()``), the
  proxy synthesizes the evacuation the corpse can no longer answer:
  requests that never streamed a token are harvested for bit-exact
  requeue on siblings (seeds were resolved at router submit), requests
  caught mid-decode flush their streamed partial to the waiter — the
  same split ``evacuate(flush_partials=True)`` performs in-process.

- The connection self-heals: a severed link (chaos ``net.*`` fires, a
  host restart) reconnects lazily on the next call, and the host
  forwards pushes to every live connection, so rids survive a
  reconnect (they live in the host server, not the socket).

``spawn_replica_host(factory)`` is the process-isolation entry point:
it spawns a child that builds the server from a picklable factory,
serves it, and reports the bound port — the unit the kill-drill
acceptance test SIGKILLs mid-decode.
"""
import collections
import threading
import time

import numpy as np

from ..reliability import DEAD, DRAINING, RetryPolicy, TransportError
from ..reliability.errors import (CallbackError, FrameError,
                                  MigrationError)
from ..telemetry.clock import MonotonicClock
from . import transport
from .transport import (decode_snapshot, encode_snapshot, jsonable,
                        marshal_error, unmarshal_error)

__all__ = ["ReplicaHost", "RemoteReplica", "spawn_replica_host"]

# ops whose handler may block (graceful drains, thread joins): each
# runs on its own short-lived thread so the connection's reader keeps
# servicing quick ops (submit/cancel/digest reads) meanwhile. The
# high-frequency blocking op — "wait", issued once per wait slice per
# outstanding request — runs on a small persistent pool instead:
# thread-per-call there would be continuous create/teardown churn on
# the serving hot path.
_THREADED_OPS = frozenset({"stop", "kill", "start", "shutdown"})

# ops that need the CALLING connection (not just the message): a
# migrate_out streams its binary page frames back on the same socket
# that carried the request, never as a broadcast
_CONN_OPS = frozenset({"migrate_out"})


class _WireJourney:
    """Host-side stand-in for a ``telemetry.Journey`` handle: every
    event the server emits through it is pushed over the wire (keyed
    by the client's trace id) and replayed into the client's real
    recorder — so a remote replica's admission/prefill/preempt/replay
    phases land on the SAME fleet timeline as local hops. Emission
    must never fail a serve tick: pushes are best-effort."""

    __slots__ = ("_host", "tid", "where")

    def __init__(self, host, tid, where):
        self._host = host
        self.tid = tid
        self.where = where

    def event(self, phase, /, **fields):
        self._host._push({"push": "journey", "tid": self.tid,
                          "phase": str(phase), "where": self.where,
                          "f": jsonable(fields)})

    def at(self, where):
        return _WireJourney(self._host, self.tid, where)


class ReplicaHost:
    """Serve one ``ContinuousBatchingServer`` over the wire protocol.

    >>> host = ReplicaHost(server).start()
    >>> rep = RemoteReplica(host.address)     # possibly in another
    >>> router = ReplicaRouter([rep, ...])    # process entirely

    The host owns the LISTENER and the heartbeat, not the server's
    lifecycle: ``start``/``stop``/``kill`` arrive as wire ops (the
    router drives them), and ``close()`` tears down only the network
    side. ``sever()`` is the drill hook: it drops every connection and
    pauses heartbeats — the network face of a crash — while the server
    keeps its state, exactly what a SIGKILL leaves behind minus the
    process exit.
    """

    def __init__(self, server, host="127.0.0.1", port=0,
                 heartbeat_s=0.02, fault_injector=None):
        import socket
        self.server = server
        self.heartbeat_s = float(heartbeat_s)
        self._faults = fault_injector
        tele = getattr(server, "telemetry", None)
        self._registry = tele.registry if (
            tele is not None and getattr(tele, "enabled", False)) \
            else None
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.2)
        self.address = (host, self._listener.getsockname()[1])
        self._conns = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._shutdown = threading.Event()
        self._hb_pause = threading.Event()
        self._hb_seq = 0
        self.heartbeat_errors = 0
        self.last_heartbeat_error = None
        # wait() replies may be lost on a chaotic wire; results are
        # stashed so a retried wait for the same rid is idempotent
        # (bounded: oldest delivery records fall off)
        self._delivered = collections.OrderedDict()
        self._dlock = threading.Lock()
        from concurrent.futures import ThreadPoolExecutor
        self._wait_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="replica-host-wait")
        # per-rid count of tokens already pushed: every token frame
        # carries its stream OFFSET so a client behind a lossy wire
        # can tell a dropped chunk from the next one (bounded with
        # the same cap as _delivered)
        self._streamed = collections.OrderedDict()
        # inbound migration page frames, parked per transfer id until
        # the migrate_in op closes the set (bounded: an abandoned
        # transfer — client died mid-stream — ages out, never leaks)
        self._mig_in = collections.OrderedDict()
        self._threads = []

    @property
    def port(self):
        return self.address[1]

    # -------------------------------------------------------- lifecycle
    def start(self):
        """Start the accept + heartbeat threads; returns self."""
        for fn in (self._accept_loop, self._heartbeat_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self):
        """Tear down the network side (listener, connections,
        heartbeats). The server object is untouched."""
        self._stop.set()
        self._shutdown.set()
        self._wait_pool.shutdown(wait=False, cancel_futures=True)
        try:
            self._listener.close()
        except OSError:
            pass            # already closed by a prior close()
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()

    def sever(self):
        """Drill hook: cut every connection and pause heartbeats — the
        network signature of a crash, with the server state intact for
        a post-drill autopsy. ``unsever()`` resumes heartbeats (new
        connections are accepted throughout)."""
        self._hb_pause.set()
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()

    def unsever(self):
        self._hb_pause.clear()

    def pause_heartbeats(self):
        """Drill hook: stop pushing digests while keeping connections
        open — the network signature of a FROZEN (not crashed) host,
        which is exactly what the client's staleness walk
        (fresh -> draining -> dead) exists to catch."""
        self._hb_pause.set()

    def resume_heartbeats(self):
        self._hb_pause.clear()

    def wait_shutdown(self, timeout=None):
        """Block until a ``shutdown`` op (or ``close()``) — the child
        process entry point parks here."""
        return self._shutdown.wait(timeout)

    # ------------------------------------------------------------ loops
    def _accept_loop(self):
        import socket
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return          # listener closed: shutting down
            conn = transport.Connection(sock,
                                        fault_injector=self._faults,
                                        registry=self._registry)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    def _conn_loop(self, conn):
        while not self._stop.is_set():
            try:
                msg = conn.recv(timeout=0.5)
            except TimeoutError:
                continue
            except FrameError:
                # ONE corrupt frame: the stream is still in sync and no
                # call can be attributed, so drop it and keep serving —
                # a fuzzer's garbage must never wedge the host loop
                continue
            except TransportError:
                break
            if not isinstance(msg, dict):
                continue        # parsed-but-garbage payload: drop
            op, cid = msg.get("op"), msg.get("id")
            if not isinstance(op, str) or cid is None:
                continue
            if op == "wait":
                try:
                    self._wait_pool.submit(self._handle, conn, cid,
                                           op, msg)
                except RuntimeError:
                    break       # pool shut down: host is closing
            elif op in _THREADED_OPS:
                threading.Thread(target=self._handle,
                                 args=(conn, cid, op, msg),
                                 daemon=True).start()
            else:
                self._handle(conn, cid, op, msg)
        self._drop_conn(conn)

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_s):
            if self._hb_pause.is_set():
                continue
            try:
                digest = self._digest()
            except Exception as e:
                # a transient server-side error (stop/restart race, a
                # stats value jsonable chokes on) must not kill the
                # heartbeat thread — silenced heartbeats read as a
                # DEAD host and trigger a spurious evacuation
                self.heartbeat_errors += 1
                self.last_heartbeat_error = e
                continue
            self._push({"push": "digest", "d": digest})

    def _digest(self):
        srv = self.server
        self._hb_seq += 1
        return {"seq": self._hb_seq,
                "queue_depth": int(srv.queue_depth()),
                "in_flight": int(srv.in_flight()),
                "preempt_pressure": int(srv.preempt_pressure()),
                "health": srv.health,
                # disaggregated placement: the role rides
                # every digest so the router's placement scan needs no
                # extra RPC; pre-role servers read as "hybrid"
                "role": str(getattr(srv, "role", "hybrid")),
                "sketch": [int(fp) for fp in srv.prefix_sketch()],
                "stats": jsonable(dict(srv.stats)),
                # goodput ratio + MFU: routing-side views
                # see per-replica utilization from the heartbeat
                # alone, no registry pull ({} when neither the ledger
                # nor the cost catalog is wired)
                "util": jsonable(srv.utilization())
                if callable(getattr(srv, "utilization", None)) else {}}

    def _push(self, msg):
        """Best-effort broadcast to every live connection (token
        chunks, journey events, digests). A connection that fails mid-
        push is dropped — its client will reconnect or be declared
        dead by staleness."""
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.send(msg)
            except FrameError:
                return      # push too big for one frame: skip it for
            #                 every client (stream untouched, conn fine)
            except (TransportError, OSError):
                self._drop_conn(conn)

    def _drop_conn(self, conn):
        conn.close()
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)

    # --------------------------------------------------------- dispatch
    def _handle(self, conn, cid, op, msg):
        try:
            fn = getattr(self, "_op_" + op, None)
            if fn is None:
                raise ValueError(f"unknown wire op {op!r}")
            result = fn(conn, msg) if op in _CONN_OPS else fn(msg)
        except Exception as e:
            reply = {"re": cid, "ok": False, "err": marshal_error(e)}
        else:
            reply = {"re": cid, "ok": True, "r": result}
        try:
            conn.send(reply)
        except FrameError as e:
            # the REPLY itself was too big for one frame (e.g. a huge
            # evacuate payload): the send refused before touching the
            # socket, so the stream is intact — fail ONE call with the
            # typed error instead of severing a healthy connection
            try:
                conn.send({"re": cid, "ok": False,
                           "err": marshal_error(e)})
            except (TransportError, OSError):
                self._drop_conn(conn)
        except (TransportError, OSError):
            self._drop_conn(conn)

    def _op_hello(self, msg):
        return {"page_size": self.server.page_size,
                "digest": self._digest()}

    def _op_ping(self, msg):
        return "pong"

    def _op_submit(self, msg):
        srv = self.server
        journey = None
        tid = msg.get("tid")
        if tid is not None:
            journey = _WireJourney(self, tid,
                                   msg.get("where") or "replica")
        rid = srv.submit(
            np.asarray(msg["ids"], np.int32),
            max_new_tokens=int(msg["n"]), seed=msg.get("seed"),
            on_token=self._forwarder, deadline_s=msg.get("deadline_s"),
            priority=int(msg.get("priority") or 0), journey=journey)
        seed = msg.get("seed")
        if seed is None:
            # the server defaulted it; the client mirror needs the
            # RESOLVED value so a synthesized requeue draws the
            # identical sampling chain. Mirrors the default-seed rule
            # at ContinuousBatchingServer.submit — keep in sync
            # (tests/test_remote_replica.py pins the parity)
            seed = srv._seed + rid
        return {"rid": int(rid), "seed": int(seed)}

    def _forwarder(self, rid, tokens):
        # every request streams over the wire whether or not the client
        # attached an on_token: the mirror's token log is what makes a
        # SIGKILL's partials flushable. Each frame carries its stream
        # OFFSET so a chunk lost to chaos cannot leave a silent GAP in
        # the client's log — the mirror keeps a bit-exact contiguous
        # prefix, whatever the wire drops. Never raises (a dead client
        # must not fail the request on a live host).
        rid = int(rid)
        with self._dlock:
            off = self._streamed.get(rid, 0)
            self._streamed[rid] = off + len(tokens)
            # true LRU (not insertion order): evicting a rid that is
            # STILL streaming would restart its offset at 0 and let a
            # later chunk stitch a gap into the client's mirror — with
            # move-to-end, eviction needs 4096 other rids to push
            # between two of its chunks, impossible for a server whose
            # active streams are bounded by max_slots
            self._streamed.move_to_end(rid)
            while len(self._streamed) > 4096:
                self._streamed.popitem(last=False)
        self._push({"push": "tokens", "rid": rid, "off": off,
                    "toks": [int(t) for t in tokens]})

    def _op_wait(self, msg):
        rid = int(msg["rid"])
        with self._dlock:
            hit = self._delivered.get(rid)
        if hit is not None:
            kind, val = hit
            if kind == "err":
                raise unmarshal_error(val)
            return val
        try:
            out = self.server.wait(rid, timeout=float(msg["timeout"]))
        except Exception as e:
            # a plain TimeoutError is a not-finished-yet probe and must
            # not be stashed; everything else is terminal (the server
            # popped the rid — DeadlineExceeded subclasses TimeoutError
            # but is exactly such a terminal outcome) and is stashed so
            # a retried wait after a lost reply sees the same verdict
            if type(e) is TimeoutError:
                raise
            self._stash(rid, ("err", marshal_error(e)))
            raise
        result = [int(t) for t in out]
        self._stash(rid, ("ok", result))
        return result

    def _stash(self, rid, record):
        with self._dlock:
            self._delivered[rid] = record
            while len(self._delivered) > 4096:
                self._delivered.popitem(last=False)

    def _op_cancel(self, msg):
        return bool(self.server.cancel(int(msg["rid"])))

    def _op_evacuate(self, msg):
        srv = self.server
        harvested = srv.evacuate(
            flush_partials=bool(msg.get("flush_partials")))
        now = srv._clock.now()
        out = []
        for item in harvested:
            rem = None if item.deadline is None \
                else max(0.0, item.deadline - now)
            out.append({"rid": int(item.rid),
                        "ids": [int(t) for t in item.ids],
                        "budget": int(item.budget),
                        "seed": int(item.seed),
                        "deadline_s": rem,
                        "priority": int(item.priority)})
        return out

    def _op_abandon(self, msg):
        return bool(self.server.abandon(int(msg["rid"]),
                                        unmarshal_error(msg["err"])))

    # --------------------------------------------- live KV-page migration
    def _op_migrate_out(self, conn, msg):
        """Pause one live request (mid-decode, or mid-prefill for the
        prefill handoff) and stream its KV pages BACK to the calling
        connection as binary page frames (one frame per page, K and V
        stacked, sha256-checked by the transport), then reply with the
        serialized migration state. The slot stays paused until the
        caller settles with migrate_finish / migrate_abort; a failure
        streaming the pages aborts HERE (the caller may never be able
        to ask) and fails the call typed. ``partial=True`` is the
        NON-pausing pipelined pull: one bounded batch of complete
        mid-prefill pages streams back and the slot keeps chunking —
        nothing to abort on failure."""
        rid = int(msg["rid"])
        xid = msg.get("xid")
        partial = bool(msg.get("partial"))
        state, payloads = self.server.migrate_out(
            rid, partial=partial,
            from_page=int(msg.get("from_page") or 0))
        try:
            for i, p in enumerate(payloads):
                a = np.ascontiguousarray(np.stack(p))   # [2, L, pg, ...]
                conn.send_pages(
                    {"push": "pages", "xid": xid, "i": i,
                     "n": len(payloads), "shape": list(a.shape),
                     "dtype": str(a.dtype)}, a.tobytes())
        except Exception as e:
            if not partial:
                self.server.migrate_abort(rid)
            raise MigrationError(
                f"page stream to the caller failed at frame "
                f"{i}/{len(payloads)}: {e!r}") from e
        return jsonable(state)

    def _op_migrate_page(self, msg):
        """One inbound migration page frame (fire-and-forget, id 0):
        park the raw payload under its transfer id until migrate_in
        closes the set. Malformed frames are dropped — the completeness
        check in _op_migrate_in degrades that attempt typed."""
        xid = msg.get("xid")
        buf = msg.get("_payload")
        if xid is None or buf is None:
            return False
        a = np.frombuffer(buf, dtype=np.dtype(msg["dtype"]))
        a = a.reshape(msg["shape"])
        with self._dlock:
            slot = self._mig_in.setdefault(xid, {})
            slot[int(msg["i"])] = a
            self._mig_in.move_to_end(xid)
            while len(self._mig_in) > 8:
                self._mig_in.popitem(last=False)
        return True

    def _op_migrate_in(self, msg):
        """Commit a migration INTO this host's server: reassemble the
        parked page payloads, restore through the server's normal admit
        path, and continue the token stream at the source's offset (the
        client mirror already holds the pre-migration prefix, so the
        forwarder must not restart at 0)."""
        xid = msg.get("xid")
        state = dict(msg["state"])
        with self._dlock:
            got = self._mig_in.pop(xid, None) or {}
        n = len(state.get("sha256") or ())
        payloads = [got.get(i) for i in range(n)]
        if n == 0 or any(p is None for p in payloads):
            raise MigrationError(
                f"page frames lost on the wire: {len(got)}/{n} arrived "
                f"for transfer {xid!r}")
        journey = None
        tid = msg.get("tid")
        if tid is not None:
            journey = _WireJourney(self, tid,
                                   msg.get("where") or "replica")
        rid = self.server.migrate_in(state, payloads,
                                     on_token=self._forwarder,
                                     journey=journey)
        with self._dlock:
            self._streamed[int(rid)] = int(state.get("streamed") or 0)
            self._streamed.move_to_end(int(rid))
        return {"rid": int(rid)}

    def _op_migrate_in_begin(self, msg):
        """Open a pipelined (staged) restore on this host's server —
        the target half of a disaggregated prefill handoff. Replies
        with the transfer handle the page batches and the commit key
        off."""
        return {"handle": int(self.server.migrate_in_begin(
            dict(msg["state"])))}

    def _op_migrate_in_pages(self, msg):
        """Land one pipelined page batch: reassemble whatever frames of
        the batch survived the wire (parked by ``_op_migrate_page``
        under the transfer id) and scatter each surviving page at its
        absolute index — holes are REPORTED, not fatal, so the pump
        re-ships exactly what the storm ate and the commit's coverage
        check stays the single source of truth."""
        xid = msg.get("xid")
        with self._dlock:
            got = self._mig_in.pop(xid, None) or {}
        sha = list(msg.get("sha256") or ())
        base = int(msg.get("base") or 0)
        handle = int(msg["handle"])
        landed, lost = [], []
        for i in range(len(sha)):
            p = got.get(i)
            if p is None:
                lost.append(base + i)
                continue
            self.server.migrate_in_pages(handle, base + i, [p],
                                         [sha[i]])
            landed.append(base + i)
        return {"landed": landed, "lost": lost}

    def _op_migrate_in_commit(self, msg):
        """Close a pipelined restore: reassemble the parked closing
        frames (ALL of them must have arrived — the closing batch is
        the commit point, holes degrade the attempt typed with the
        staging kept), commit through the server, and continue the
        token stream at the source's offset exactly like
        ``_op_migrate_in``."""
        xid = msg.get("xid")
        state = dict(msg["state"])
        with self._dlock:
            got = self._mig_in.pop(xid, None) or {}
        n = len(state.get("sha256") or ())
        payloads = [got.get(i) for i in range(n)]
        if any(p is None for p in payloads):
            raise MigrationError(
                f"closing page frames lost on the wire: "
                f"{sum(p is not None for p in payloads)}/{n} arrived "
                f"for transfer {xid!r}")
        journey = None
        tid = msg.get("tid")
        if tid is not None:
            journey = _WireJourney(self, tid,
                                   msg.get("where") or "replica")
        rid = self.server.migrate_in_commit(
            int(msg["handle"]), state, payloads,
            on_token=self._forwarder, journey=journey)
        with self._dlock:
            self._streamed[int(rid)] = int(state.get("streamed") or 0)
            self._streamed.move_to_end(int(rid))
        return {"rid": int(rid)}

    def _op_migrate_in_abort(self, msg):
        return bool(self.server.migrate_in_abort(int(msg["handle"])))

    def _op_migrate_finish(self, msg):
        rid = int(msg["rid"])
        self.server.migrate_finish(rid)
        with self._dlock:
            self._streamed.pop(rid, None)
        return True

    def _op_migrate_abort(self, msg):
        return bool(self.server.migrate_abort(int(msg["rid"])))

    def _op_fetch_tokens(self, msg):
        """Backfill a gap the wire chewed into a client's token stream:
        re-push this request's emitted tokens from ``off`` onward as a
        normal offset-carrying token frame,
        read from whatever still remembers them — the live slot, the
        preempted parking lot, the finished-result map, or the wait
        delivery stash. Returns the number of tokens re-pushed (None:
        rid unknown here, nothing to repair from)."""
        rid = int(msg["rid"])
        off = max(0, int(msg.get("off") or 0))
        srv = self.server
        toks = None
        with self._dlock:
            hit = self._delivered.get(rid)
        if hit is not None and hit[0] == "ok":
            toks = list(hit[1])
        if toks is None:
            with srv._lock:
                for st in srv._slots:
                    if st is not None and st.rid == rid:
                        toks = [int(t) for t in st.emitted]
                        break
                if toks is None:
                    for rec in srv._preempted:
                        if rec.rid == rid:
                            toks = [int(t) for t in rec.emitted]
                            break
                if toks is None:
                    out = srv._results.get(rid)
                    if out is not None:
                        toks = [int(t) for t in out]
        if toks is None:
            return None
        back = [int(t) for t in toks[off:]]
        if back:
            self._push({"push": "tokens", "rid": rid, "off": off,
                        "toks": back})
        return len(back)

    def _op_stats(self, msg):
        return jsonable(dict(self.server.stats))

    def _op_health(self, msg):
        return self.server.health

    def _op_pool_balance(self, msg):
        bal = self.server.pool_balance()
        if bal is None:
            return None
        return {"free": bal[0], "live": bal[1], "pinned": bal[2],
                "cached": bal[3], "preempted": bal.preempted,
                "preemptions": bal.preemptions}

    def _op_snapshot(self, msg):
        tele = getattr(self.server, "telemetry", None)
        if tele is None or not getattr(tele, "enabled", False):
            return None
        return encode_snapshot(tele.registry.snapshot())

    def _op_postmortems(self, msg):
        return jsonable(self.server.postmortems())

    def _op_start(self, msg):
        if self.server._thread is None:
            self.server.start()
        return True

    def _op_stop(self, msg):
        self.server.stop(timeout=float(msg.get("timeout") or 60.0),
                         drain=bool(msg.get("drain")))
        return True

    def _op_kill(self, msg):
        self.server.kill(timeout=float(msg.get("timeout") or 60.0))
        return True

    def _op_shutdown(self, msg):
        # reply is sent by _handle after we return; close on a helper
        # thread so the farewell frame gets out first
        def later():
            time.sleep(0.05)
            self.close()
        threading.Thread(target=later, daemon=True).start()
        return True


class _Call:
    __slots__ = ("evt", "result", "err", "on_reply", "conn")

    def __init__(self, on_reply=None, conn=None):
        self.evt = threading.Event()
        self.result = None
        self.err = None
        self.on_reply = on_reply
        self.conn = conn              # the connection that carried it:
        #                               a dying conn settles only ITS
        #                               calls, never a successor's


class _Mirror:
    """Client-side shadow of one in-flight remote request — everything
    a synthesized evacuation needs when the host can no longer answer."""

    __slots__ = ("rid", "ids", "budget", "seed", "on_token", "deadline",
                 "priority", "journey", "tid", "tokens", "done")

    def __init__(self, rid, ids, budget, seed, on_token, deadline,
                 priority, journey, tid):
        self.rid = rid
        self.ids = ids
        self.budget = budget
        self.seed = seed
        self.on_token = on_token
        self.deadline = deadline      # CLIENT-clock absolute, or None
        self.priority = priority
        self.journey = journey
        self.tid = tid
        self.tokens = []              # streamed so far (wire pushes)
        self.done = False


class _Harvested:
    """One synthesized/decoded evacuation entry — duck-compatible with
    the server's ``_Pending`` as far as the router reads it."""

    __slots__ = ("rid", "ids", "budget", "seed", "on_token", "deadline",
                 "priority", "journey")

    def __init__(self, rid, ids, budget, seed, on_token, deadline,
                 priority, journey):
        self.rid = rid
        self.ids = ids
        self.budget = budget
        self.seed = seed
        self.on_token = on_token
        self.deadline = deadline
        self.priority = priority
        self.journey = journey


class RemoteReplica:
    """Client proxy speaking the wire protocol; implements the exact
    replica surface ``ReplicaRouter`` consumes (submit / wait / cancel
    / evacuate / health / queue_depth / in_flight / preempt_pressure /
    prefix_sketch / abandon / postmortems / start / stop / kill /
    ``page_size``), so a router routes over it UNCHANGED.

    ``draining_after_s`` / ``dead_after_s`` bound digest staleness:
    past the first the replica stops taking new traffic, past the
    second the supervisor treats it as dead and evacuates. Both must
    comfortably exceed the host's ``heartbeat_s`` (defaults assume the
    0.02 s default cadence; scale them together).

    ``registry`` (``telemetry.MetricRegistry``) publishes the wire
    counters (``net_frames_total{dir}`` / ``net_bytes_total{dir}`` /
    ``net_transport_errors_total``), ``net_call_seconds`` round-trip
    latency, and ``net_heartbeats_total``.

    ``fault_injector`` arms the ``net.*`` chaos points on this
    client's connections (see ``reliability.faults``). Construction
    dials the host once and raises ``TransportError`` if it cannot —
    arm probabilistic storms after the fleet is built (or window them
    with ``start=``), the way the chaos suites do.
    """

    telemetry = None        # fleet_snapshot merges via registry_snapshot

    def __init__(self, address, clock=None, fault_injector=None,
                 registry=None, connect_timeout=5.0,
                 draining_after_s=0.25, dead_after_s=0.75,
                 call_timeout_s=30.0, reconnect_min_s=0.05, name=None):
        self.address = (str(address[0]), int(address[1]))
        self.name = name or f"{self.address[0]}:{self.address[1]}"
        self._clock = clock if clock is not None else MonotonicClock()
        self._faults = fault_injector
        self._registry = registry if (
            registry is not None and getattr(registry, "enabled", False)
        ) else None
        self.connect_timeout = float(connect_timeout)
        self.draining_after_s = float(draining_after_s)
        self.dead_after_s = float(dead_after_s)
        self.call_timeout_s = float(call_timeout_s)
        self.snapshot_timeout_s = 2.0
        self.reconnect_min_s = float(reconnect_min_s)
        self._h_call = self._c_hb = None
        if self._registry is not None:
            self._h_call = self._registry.histogram(
                "net_call_seconds",
                "Wire RPC round-trip latency (request frame out to "
                "reply frame in)")
            self._c_hb = self._registry.counter(
                "net_heartbeats_total",
                "Replica load digests received over the wire")
        self._conn = None
        self._conn_lock = threading.RLock()
        self._last_attempt = 0.0
        self._closed = False
        self._calls = {}
        self._id_lock = threading.Lock()
        self._next_id = 1
        self._state_lock = threading.RLock()
        self._mirror = {}             # replica rid -> _Mirror
        self._journeys = {}           # tid -> Journey handle
        self._results = {}            # locally settled (synth evacuate)
        self._failures = {}
        # token pushes racing ahead of their submit REPLY (the host's
        # serve thread streams independently of the conn thread that
        # answers the submit): parked here until the mirror registers,
        # bounded — unclaimed entries are dropped oldest-first
        self._early_tokens = collections.OrderedDict()  # rid -> [msg]
        # binary page frames for in-flight migrate_out calls, parked
        # per transfer id until the state reply closes the set
        self._mig_pages = {}          # xid -> {page index: ndarray}
        # retry/backoff for the migration wire ops (transient failures
        # only — a typed host refusal never retries)
        self.migrate_retry = RetryPolicy(base_delay_s=0.02,
                                         max_delay_s=0.25)
        self.migrate_attempts = 3
        self._digest = None
        self._sketch = frozenset()
        self._last_hb = -1e9
        self.page_size = None
        self._thread = None           # router start()/stop() contract
        self._thread_error = None     # router wait() identity contract
        self._connect()               # raises TransportError on failure

    # ------------------------------------------------------- connection
    def _connect(self):
        conn = transport.connect(self.address,
                                 timeout=self.connect_timeout,
                                 fault_injector=self._faults,
                                 registry=self._registry)
        try:
            conn.send({"id": 0, "op": "hello"})
            deadline = time.monotonic() + self.connect_timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TransportError(
                        f"{self.name}: no hello reply in "
                        f"{self.connect_timeout}s")
                try:
                    msg = conn.recv(timeout=remaining)
                except (TimeoutError, FrameError) as e:
                    raise TransportError(
                        f"{self.name}: handshake failed: {e}") from e
                if isinstance(msg, dict) and msg.get("re") == 0:
                    break
                self._dispatch_push(msg)    # digests may arrive first
        except TransportError:
            conn.close()
            raise
        if not msg.get("ok"):
            conn.close()
            raise TransportError(
                f"{self.name}: hello refused: {msg.get('err')}")
        hello = msg["r"]
        self.page_size = hello.get("page_size")
        with self._conn_lock:
            self._conn = conn
            # _thread_error is NOT cleared on reconnect: the router's
            # wait() path discriminates stale-vs-real errors by
            # __cause__ IDENTITY with this attribute, and a waiter
            # mid-raise must still match it — a live connection (not a
            # None error) is what marks the proxy healthy again
        self._on_digest(hello.get("digest"))
        threading.Thread(target=self._reader, args=(conn,),
                         daemon=True).start()
        return conn

    def _ensure_conn(self):
        with self._conn_lock:
            if self._closed:
                raise TransportError(f"{self.name}: client closed")
            conn = self._conn
            if conn is not None and not conn.closed:
                return conn
            now = time.monotonic()
            if now - self._last_attempt < self.reconnect_min_s:
                err = TransportError(
                    f"{self.name}: disconnected (reconnect backoff)")
                err.__cause__ = self._thread_error
                raise err
            self._last_attempt = now
            return self._connect()

    def _reader(self, conn):
        while not self._closed:
            try:
                msg = conn.recv(timeout=0.5)
            except TimeoutError:
                continue
            except FrameError:
                continue            # one corrupt frame: stream resynced
            except TransportError as e:
                self._on_disconnect(conn, e)
                return
            if isinstance(msg, dict) and "re" in msg:
                self._settle(msg)
            else:
                self._dispatch_push(msg)
        self._on_disconnect(conn, TransportError(
            f"{self.name}: client closed"))

    def _settle(self, msg):
        call = self._calls.get(msg.get("re"))
        if call is None:
            return                  # reply to a timed-out call: drop
        if msg.get("ok"):
            call.result = msg.get("r")
            if call.on_reply is not None:
                # runs IN the reader so a mirror is registered before
                # any later push frame for the same rid is processed
                call.on_reply(call.result)
        else:
            call.err = unmarshal_error(msg.get("err") or {})
        call.evt.set()

    def _dispatch_push(self, msg):
        if not isinstance(msg, dict):
            return
        kind = msg.get("push")
        if kind == "digest":
            self._on_digest(msg.get("d"))
        elif kind == "tokens":
            self._on_tokens(msg)
        elif kind == "journey":
            self._on_journey(msg)
        elif kind == "pages":
            self._on_pages(msg)

    def _on_pages(self, msg):
        """One binary page frame for an in-flight migrate_out: park it
        under its transfer id. Frames for unknown transfer ids (an
        aborted or retried attempt, another client's migration riding
        the broadcast path) are dropped; a malformed header drops ONE
        frame and the completeness check downstream degrades that
        attempt typed."""
        xid = msg.get("xid")
        buf = msg.get("_payload")
        with self._state_lock:
            slot = self._mig_pages.get(xid)
            if slot is None or buf is None:
                return
            try:
                a = np.frombuffer(buf, dtype=np.dtype(msg["dtype"]))
                slot[int(msg["i"])] = a.reshape(msg["shape"])
            except Exception:
                return

    def _on_digest(self, d):
        if not isinstance(d, dict):
            return
        self._sketch = frozenset(d.get("sketch") or ())
        self._digest = d
        self._last_hb = self._clock.now()
        if self._c_hb is not None:
            self._c_hb.inc()

    def _on_tokens(self, msg):
        with self._state_lock:
            m = self._mirror.get(msg.get("rid"))
            if m is None:
                # no mirror YET: either this push raced ahead of the
                # submit reply (park it; the reply's on_reply hook
                # drains the parked frames in order) or the rid is
                # truly foreign (dropped submit reply / another
                # client) and the bounded buffer ages it out
                rid = msg.get("rid")
                if rid is not None:
                    parked = self._early_tokens.setdefault(rid, [])
                    if len(parked) < 32:
                        # per-rid cap too: a FOREIGN stream (another
                        # client's rid, broadcast to every connection)
                        # must not park its whole token log here
                        parked.append(msg)
                    while len(self._early_tokens) > 256:
                        self._early_tokens.popitem(last=False)
                return
            if m.done:
                return              # already settled locally
            toks = list(msg.get("toks") or ())
            have = len(m.tokens)
            off = msg.get("off")
            off = have if off is None else int(off)
            if off > have:
                # an earlier chunk was lost to the wire: appending this
                # one would punch a silent GAP into the partial (and the
                # user's stream). Keep the contiguous prefix — and ask
                # the host to BACKFILL from its own emitted-token log
                # (fire-and-forget: we are ON the reader thread; the
                # repair arrives as a normal offset-carrying token push
                # that stitches the prefix back together, re-covering
                # this chunk's range too). Re-asked on every subsequent
                # out-of-order chunk, so a repair the storm also eats
                # is retried for free.
                self._post("fetch_tokens", rid=int(msg["rid"]),
                           off=have)
                return
            toks = [int(t) for t in toks[have - off:]]
            if not toks:
                return              # duplicate/overlapping chunk
            m.tokens.extend(toks)
            cb = m.on_token
            if len(m.tokens) >= m.budget:
                # the stream just delivered the full budget: settle the
                # request locally so a client that never calls wait()
                # (pure streaming consumer) does not pin its mirror
                # forever, and a later wait() returns without a wire
                # round trip. (An early-EOS finish below budget still
                # settles via wait(); _results/_failures are bounded
                # for the never-waited case.)
                self._mirror.pop(msg["rid"], None)
                m.done = True
                self._journeys.pop(m.tid, None)
                self._results[msg["rid"]] = np.asarray(
                    m.tokens[:m.budget], np.int32)
                self._bound_settled_locked()
        if cb is None:
            return
        try:
            cb(msg["rid"], np.asarray(toks, np.int32))
        except Exception as e:
            # mirror the in-process contract: a poisoned stream fails
            # exactly ITS request, typed, and never kills the reader
            err = CallbackError([(msg["rid"], e)],
                                what="on_token callback")
            with self._state_lock:
                m = self._mirror.pop(msg["rid"], None)
                if m is not None:
                    m.done = True
                    self._journeys.pop(m.tid, None)
                self._failures[msg["rid"]] = err
            self._post("cancel", rid=int(msg["rid"]))

    def _on_journey(self, msg):
        handle = self._journeys.get(msg.get("tid"))
        if handle is None:
            return
        fields = msg.get("f") or {}
        try:
            handle._rec.event(handle.tid, str(msg.get("phase")),
                              str(msg.get("where") or handle.where),
                              **{str(k): v for k, v in fields.items()})
        except Exception:
            return      # a debug artifact must never wedge the reader

    def _on_disconnect(self, conn, err):
        conn.close()
        with self._conn_lock:
            if conn is self._conn:
                self._conn = None
                self._thread_error = err
        # unblock the calls THIS connection carried — a call already
        # riding a reconnected successor must not be spuriously failed
        # by the old reader thread's dying gasp
        for call in list(self._calls.values()):
            if call.conn is conn and not call.evt.is_set():
                call.err = err
                call.evt.set()

    # ------------------------------------------------------------ calls
    def _call(self, op, reply_timeout=None, on_reply=None, **args):
        """One request-reply round trip. ``reply_timeout`` bounds the
        CLIENT-side wait for the reply frame (wire-op arguments like a
        remote wait's ``timeout`` travel in ``args``)."""
        conn = self._ensure_conn()
        with self._id_lock:
            cid = self._next_id
            self._next_id += 1
        call = _Call(on_reply, conn=conn)
        self._calls[cid] = call
        t0 = time.monotonic()
        try:
            conn.send({"id": cid, "op": op, **args})
            budget = self.call_timeout_s if reply_timeout is None \
                else reply_timeout
            if not call.evt.wait(budget):
                raise TimeoutError(
                    f"{self.name}: {op} got no reply in {budget:.3g}s "
                    f"(frame lost or host stalled)")
        finally:
            self._calls.pop(cid, None)
        if call.err is not None:
            raise call.err
        if self._h_call is not None:
            self._h_call.observe(time.monotonic() - t0)
        return call.result

    def _post(self, op, **args):
        """Fire-and-forget wire op from the READER thread (its reply,
        addressed to the reserved id 0, is dropped by ``_settle``) — a
        blocking ``_call`` here would deadlock on the reader itself."""
        conn = self._conn
        if conn is None:
            return
        try:
            conn.send({"id": 0, "op": op, **args})
        except (TransportError, OSError):
            pass        # host unreachable: the local outcome stands

    def ping(self):
        """One wire round trip; returns its latency in seconds (the
        router bench's per-call overhead probe)."""
        t0 = time.monotonic()
        self._call("ping")
        return time.monotonic() - t0

    # ---------------------------------------------------- client surface
    def submit(self, input_ids, max_new_tokens=32, seed=None,
               on_token=None, deadline_s=None, priority=0,
               journey=None):
        """Submit one prompt to the remote server; returns the REMOTE
        request id. Same contract as
        ``ContinuousBatchingServer.submit`` — deadlines travel as
        remaining seconds and re-anchor on the host's clock; the
        resolved seed comes back with the reply so a synthesized
        failover requeue replays the identical sampling chain."""
        ids = np.asarray(input_ids).astype(np.int32).reshape(-1)
        tid = getattr(journey, "tid", None)
        where = getattr(journey, "where", None)
        if tid is not None:
            self._journeys[tid] = journey
        deadline = None if deadline_s is None \
            else self._clock.now() + float(deadline_s)

        def record(reply):
            with self._state_lock:
                self._mirror[reply["rid"]] = _Mirror(
                    reply["rid"], ids, int(max_new_tokens),
                    int(reply["seed"]), on_token, deadline,
                    int(priority), journey, tid)
                parked = self._early_tokens.pop(reply["rid"], ())
            for pm in parked:       # pushes that raced this reply
                self._on_tokens(pm)

        try:
            reply = self._call(
                "submit", ids=[int(t) for t in ids],
                n=int(max_new_tokens), seed=seed,
                deadline_s=deadline_s, priority=int(priority),
                tid=tid, where=where, on_reply=record)
        except BaseException:
            if tid is not None:
                self._journeys.pop(tid, None)
            raise
        return reply["rid"]

    def wait(self, rid, timeout=120.0):
        """Block until ``rid`` finishes; returns its new tokens.
        Results synthesized locally (a flushed partial from a dead
        host) win; otherwise the wire is polled in bounded slices so a
        reply lost to chaos costs one slice, not the whole timeout."""
        deadline = time.monotonic() + timeout
        while True:
            with self._state_lock:
                if rid in self._results:
                    self._settle_mirror(rid)
                    return self._results.pop(rid)
                if rid in self._failures:
                    self._settle_mirror(rid)
                    raise self._failures.pop(rid)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"request {rid} not finished in {timeout}s")
            if self._conn is None:
                # host unreachable: hold the waiter (like a dead serve
                # thread) — the supervisor's failover settles the rid.
                # __cause__ IDENTITY with _thread_error is the router's
                # stale-vs-real discriminator, same as in-process.
                err = self._thread_error
                if err is not None:
                    e = RuntimeError(
                        f"{self.name}: connection lost; request {rid} "
                        f"awaiting failover")
                    e.__cause__ = err
                    raise e
            span = min(remaining, 1.0)
            try:
                out = self._call("wait", rid=int(rid), timeout=span,
                                 reply_timeout=span + 2.0)
            except TransportError:
                time.sleep(0.01)
                continue        # reconnect/backoff loop; re-check state
            except TimeoutError as e:
                # only a PLAIN TimeoutError is "not finished yet" —
                # DeadlineExceeded subclasses it and is a terminal,
                # typed request outcome that must reach the caller
                if type(e) is TimeoutError:
                    continue
                self._settle_all(rid)
                raise
            except Exception:
                self._settle_all(rid)
                raise           # typed failure unmarshalled remotely
            else:
                self._reconcile_stream(rid, out)
                self._settle_all(rid)
                return np.asarray(out, np.int32)

    def _reconcile_stream(self, rid, toks):
        """Terminal backfill: a wire-returned result is the WHOLE
        stream, so any token pushes chaos ate with nothing behind them
        to trigger a ``fetch_tokens`` re-ask are delivered to the
        stream callback here, before the mirror settles — a waited
        request's callback never ends truncated."""
        with self._state_lock:
            m = self._mirror.get(rid)
            if m is None or m.done or m.on_token is None:
                return
            tail = [int(t) for t in toks[len(m.tokens):]]
            if not tail:
                return
            m.tokens.extend(tail)
            cb = m.on_token
        try:
            cb(rid, tail)
        except Exception:
            pass                # a poisoned stream cannot spoil wait()

    def _settle_mirror(self, rid):
        m = self._mirror.pop(rid, None)
        if m is not None:
            m.done = True
            self._journeys.pop(m.tid, None)

    def _settle_all(self, rid):
        """Wire-delivered outcome for ``rid``: drop the mirror AND any
        concurrently stream-settled local copy — a wait that returned
        via the wire while the final token push also settled locally
        must not strand one result array per request."""
        with self._state_lock:
            self._settle_mirror(rid)
            self._results.pop(rid, None)
            self._failures.pop(rid, None)

    def _bound_settled_locked(self):
        """Cap the locally settled maps (a pure-streaming client may
        never ``wait()``; dropped entries are simply re-fetched from
        the host's own delivery stash if a late wait does arrive)."""
        for d in (self._results, self._failures):
            while len(d) > 4096:
                d.pop(next(iter(d)))

    def cancel(self, rid):
        try:
            return bool(self._call("cancel", rid=int(rid)))
        except (TransportError, TimeoutError):
            return False    # unreachable host: failover settles it

    # ------------------------------------------- live KV-page migration
    def _mint_xid(self):
        with self._id_lock:
            xid = f"x{self._next_id}"
            self._next_id += 1
        return xid

    def migrate_out(self, rid, retry=None, partial=False, from_page=0):
        """Pause ``rid`` on the host and pull its full resumable state
        over the wire: the serialized migration dict plus one host
        array per KV page (binary page frames, sha256-checked per
        frame by the transport and end-to-end again by the target's
        ``migrate_in``). Transient failures — a severed call, page
        frames the storm ate — RESUME the slot and retry with backoff;
        a typed host refusal (``MigrationError``: unknown rid, dense
        backend) propagates immediately so the caller degrades to
        evacuate+replay. The client mirror stays registered until
        ``migrate_finish`` commits the handoff.

        ``partial=True`` pulls one NON-pausing pipelined batch of a
        mid-prefill slot's complete pages (single attempt, no resume
        needed — nothing pauses); frames the wire ate come back as
        ``None`` holes in the payload list, so the pump re-ships
        exactly those. ``from_page`` skips pages the target already
        holds on the closing full pull."""
        if partial:
            return self._migrate_out_partial(rid)
        policy = retry if retry is not None else self.migrate_retry
        last = None
        for attempt in range(self.migrate_attempts):
            if attempt:
                policy.sleep(attempt - 1)
            xid = self._mint_xid()
            with self._state_lock:
                self._mig_pages[xid] = {}
            try:
                try:
                    state = self._call("migrate_out", rid=int(rid),
                                       xid=xid,
                                       from_page=int(from_page))
                except MigrationError:
                    raise             # host refusal: not transient
                except (TransportError, TimeoutError) as e:
                    last = e
                    self.migrate_abort(rid)   # resume if it paused
                    continue
                with self._state_lock:
                    got = self._mig_pages.get(xid) or {}
                n = len(state.get("sha256") or ())
                payloads = [got.get(i) for i in range(n)]
                # zero payloads are legitimate for a prefill handoff
                # (nothing written yet) or a closing pull whose pages
                # all streamed ahead (from_page == written extent)
                empty_ok = int(state.get("base") or 0) > 0 \
                    or str(state.get("phase") or "decode") == "prefill"
                if (n == 0 and not empty_ok) \
                        or any(p is None for p in payloads):
                    last = MigrationError(
                        f"{self.name}: request {rid}: page frames lost "
                        f"on the wire ({len(got)}/{n} arrived)")
                    self.migrate_abort(rid)   # slot is paused: resume
                    continue
                # the server fires token callbacks AFTER releasing its
                # tick lock, so a cut landing in that window returns
                # `streamed` ahead of what this wire has seen — the
                # pushes are in flight on a live conn and the slot is
                # paused (`streamed` is final), so wait for the mirror
                # to catch up before snapshotting; a timeout means the
                # push was genuinely lost (dying host) and client truth
                # stands — the target re-streams the gap
                srv_streamed = int(state.get("streamed") or 0)
                catchup = time.monotonic() + 2.0
                while time.monotonic() < catchup:
                    with self._state_lock:
                        m = self._mirror.get(rid)
                        if m is None or len(m.tokens) >= srv_streamed:
                            break
                    time.sleep(0.002)
                with self._state_lock:
                    m = self._mirror.get(rid)
                    if m is not None:
                        # CLIENT-truth delivery offset: the target
                        # seeds its mirror from this, so gap repair
                        # picks up exactly where this wire left off
                        state["delivered"] = [int(t) for t in m.tokens]
                return state, payloads
            finally:
                with self._state_lock:
                    self._mig_pages.pop(xid, None)
        raise last

    def migrate_in(self, state, payloads, on_token=None, journey=None):
        """Restore a migrated request INTO this replica: stream the
        page payloads as binary frames, then commit with the state
        (the reply is the COMMIT POINT — the new remote rid). A mirror
        is registered client-side, seeded with the already-delivered
        token prefix, so dead-host synthesis and gap repair keep
        working across the handoff. Any failure propagates — the
        caller aborts the source and falls back."""
        conn = self._ensure_conn()
        xid = self._mint_xid()
        for i, p in enumerate(payloads):
            a = np.ascontiguousarray(np.stack(p) if isinstance(p, list)
                                     else p)
            conn.send_pages({"id": 0, "op": "migrate_page", "xid": xid,
                             "i": i, "n": len(payloads),
                             "shape": list(a.shape),
                             "dtype": str(a.dtype)}, a.tobytes())
        tid = getattr(journey, "tid", None)
        where = getattr(journey, "where", None)
        if tid is not None:
            self._journeys[tid] = journey
        streamed = int(state.get("streamed") or 0)
        pre = state.get("delivered")
        if pre is None:
            # in-process sources stream synchronously: server-truth
            # offset IS client truth there
            pre = (state.get("emitted") or [])[:streamed]
        pre = [int(t) for t in pre]
        deadline = None if state.get("deadline_s") is None \
            else self._clock.now() + float(state["deadline_s"])

        def record(reply):
            with self._state_lock:
                m = _Mirror(reply["rid"],
                            np.asarray(state["ids"], np.int32),
                            int(state["budget"]), int(state["seed"]),
                            on_token, deadline,
                            int(state.get("priority") or 0),
                            journey, tid)
                m.tokens = list(pre)
                self._mirror[reply["rid"]] = m
                parked = self._early_tokens.pop(reply["rid"], ())
            for pm in parked:         # pushes that raced this reply
                self._on_tokens(pm)

        try:
            reply = self._call("migrate_in", xid=xid,
                               state=jsonable(state), tid=tid,
                               where=where, on_reply=record)
        except BaseException:
            if tid is not None:
                self._journeys.pop(tid, None)
            raise
        return reply["rid"]

    def _migrate_out_partial(self, rid):
        """One pipelined batch pull (``migrate_out(partial=True)``):
        single attempt — the slot never pauses, so there is nothing to
        resume and the next poll simply re-reads progress. Lost frames
        come back as ``None`` holes; the pump re-ships them through
        the closing ``from_page`` pull."""
        xid = self._mint_xid()
        with self._state_lock:
            self._mig_pages[xid] = {}
        try:
            frag = self._call("migrate_out", rid=int(rid), xid=xid,
                              partial=True)
            with self._state_lock:
                got = self._mig_pages.get(xid) or {}
            n = len(frag.get("sha256") or ())
            return frag, [got.get(i) for i in range(n)]
        finally:
            with self._state_lock:
                self._mig_pages.pop(xid, None)

    def migrate_in_begin(self, state):
        """Open a pipelined restore on the host (disaggregated prefill
        handoff target): returns the transfer handle the page batches
        and the commit key off. Any failure propagates — the caller
        falls back to a one-shot ``migrate_in`` or local decode."""
        return int(self._call("migrate_in_begin",
                              state=jsonable(state))["handle"])

    def migrate_in_pages(self, handle, base, payloads, sha256=None):
        """Ship one pipelined page batch as binary frames and scatter
        it at page index ``base`` of the staged restore. Returns the
        list of ABSOLUTE page indices that actually landed (the wire
        may eat frames mid-storm; the pump re-ships the difference) —
        the in-process server returns a bare count instead, so pumps
        normalize on both."""
        conn = self._ensure_conn()
        xid = self._mint_xid()
        sha = list(sha256 or ())
        for i, p in enumerate(payloads):
            a = np.ascontiguousarray(np.stack(p) if isinstance(p, list)
                                     else p)
            conn.send_pages({"id": 0, "op": "migrate_page", "xid": xid,
                             "i": i, "n": len(payloads),
                             "shape": list(a.shape),
                             "dtype": str(a.dtype)}, a.tobytes())
        r = self._call("migrate_in_pages", handle=int(handle),
                       xid=xid, base=int(base), sha256=sha)
        return [int(i) for i in r.get("landed") or ()]

    def migrate_in_commit(self, handle, state, payloads=(),
                          on_token=None, journey=None):
        """Close a pipelined restore: stream the closing batch, commit
        with the full state (the reply is the COMMIT POINT — the new
        remote rid), and register the client mirror exactly like
        ``migrate_in`` so dead-host synthesis and gap repair keep
        working across the handoff."""
        conn = self._ensure_conn()
        xid = self._mint_xid()
        for i, p in enumerate(payloads):
            a = np.ascontiguousarray(np.stack(p) if isinstance(p, list)
                                     else p)
            conn.send_pages({"id": 0, "op": "migrate_page", "xid": xid,
                             "i": i, "n": len(payloads),
                             "shape": list(a.shape),
                             "dtype": str(a.dtype)}, a.tobytes())
        tid = getattr(journey, "tid", None)
        where = getattr(journey, "where", None)
        if tid is not None:
            self._journeys[tid] = journey
        streamed = int(state.get("streamed") or 0)
        pre = state.get("delivered")
        if pre is None:
            pre = (state.get("emitted") or [])[:streamed]
        pre = [int(t) for t in pre]
        deadline = None if state.get("deadline_s") is None \
            else self._clock.now() + float(state["deadline_s"])

        def record(reply):
            with self._state_lock:
                m = _Mirror(reply["rid"],
                            np.asarray(state["ids"], np.int32),
                            int(state["budget"]), int(state["seed"]),
                            on_token, deadline,
                            int(state.get("priority") or 0),
                            journey, tid)
                m.tokens = list(pre)
                self._mirror[reply["rid"]] = m
                parked = self._early_tokens.pop(reply["rid"], ())
            for pm in parked:         # pushes that raced this reply
                self._on_tokens(pm)

        try:
            reply = self._call("migrate_in_commit", handle=int(handle),
                               xid=xid, state=jsonable(state), tid=tid,
                               where=where, on_reply=record)
        except BaseException:
            if tid is not None:
                self._journeys.pop(tid, None)
            raise
        return reply["rid"]

    def migrate_in_abort(self, handle):
        """Tear down a staged restore that will never commit
        (best-effort, idempotent — an unreachable host's staging dies
        with the process)."""
        try:
            return bool(self._call("migrate_in_abort",
                                   handle=int(handle)))
        except (TransportError, TimeoutError):
            return False

    def migrate_finish(self, rid):
        """Settle a committed handoff on the source: drop the local
        mirror FIRST — a post-commit host crash must not let dead-wire
        evacuate synthesis double-deliver a request that now lives on
        the target — then release the host's paused slot best-effort
        (an unreachable host's slot dies with the process anyway)."""
        with self._state_lock:
            m = self._mirror.pop(rid, None)
            if m is not None:
                m.done = True
                self._journeys.pop(m.tid, None)
        try:
            self._call("migrate_finish", rid=int(rid))
            return True
        except (TransportError, TimeoutError, MigrationError):
            return False

    def migrate_abort(self, rid):
        """Resume a paused migration source slot (best-effort: an
        unreachable host has nothing usefully paused — the failover
        path settles the request from the mirror)."""
        try:
            return bool(self._call("migrate_abort", rid=int(rid)))
        except (TransportError, TimeoutError):
            return False

    # --------------------------------------------------- router surface
    def _wire_dead(self):
        conn = self._conn
        return conn is None or conn.closed

    @property
    def health(self):
        """Digest health bounded by staleness: a silent host walks
        ``draining`` -> ``dead`` as heartbeats go missing; a severed
        connection reads ``dead`` immediately."""
        if self._closed or self._wire_dead() or self._digest is None:
            return DEAD
        age = self._clock.now() - self._last_hb
        if age >= self.dead_after_s:
            return DEAD
        if age >= self.draining_after_s:
            return DRAINING
        return self._digest.get("health", DEAD)

    @property
    def role(self):
        """Placement role from the last heartbeat digest. Hosts that
        predate roles never send the key and read as ``"hybrid"`` — a
        mixed-version fleet routes safely instead of KeyError'ing in
        the placement scan."""
        role = (self._digest or {}).get("role")
        return role if role in ("prefill", "decode", "hybrid") \
            else "hybrid"

    def _mirror_counts(self):
        # LOCK-FREE routing read (the router calls this per submit for
        # every replica): list(dict.values()) is one atomic C-level
        # snapshot under the GIL, so no _state_lock is taken and the
        # reader thread's token pushes are never contended with. The
        # mirror holds at most queue + slots live entries, so the scan
        # is short.
        q = f = 0
        for m in list(self._mirror.values()):
            if m.done:
                continue
            if m.tokens:
                f += 1
            else:
                q += 1
        return q, f

    def queue_depth(self):
        """The router's load read. Live wire: the last pushed digest
        FLOORED by the client mirror — a burst of submits inside one
        heartbeat must weigh on the routing score immediately, not
        after the next digest lands (the digest alone made a freshly
        loaded remote look idle to least-loaded). Dead wire: the
        mirror alone — a stale digest can no longer tell the
        supervisor whether a sweep is owed."""
        if self._wire_dead():
            return self._mirror_counts()[0]
        return max(int((self._digest or {}).get("queue_depth", 0)),
                   self._mirror_counts()[0])

    def in_flight(self):
        if self._wire_dead():
            return self._mirror_counts()[1]
        return max(int((self._digest or {}).get("in_flight", 0)),
                   self._mirror_counts()[1])

    def preempt_pressure(self):
        if self._wire_dead():
            return 0
        return int((self._digest or {}).get("preempt_pressure", 0))

    def prefix_sketch(self):
        return self._sketch

    def utilization(self):
        """The replica's goodput ratio + MFU from its last heartbeat
        digest (lock-free attribute read, same staleness contract as
        the other routing reads) — ``{}`` when the remote server wires
        neither a goodput ledger nor a cost catalog, or the wire is
        dead (a corpse reports no utilization)."""
        if self._wire_dead():
            return {}
        return dict((self._digest or {}).get("util") or {})

    @property
    def stats(self):
        return dict((self._digest or {}).get("stats") or {})

    def evacuate(self, flush_partials=False):
        """Harvest this replica's queue for the router. With a live
        wire this is the host's own ``evacuate`` (deadlines come back
        as remaining seconds and re-anchor here). With the wire DEAD it
        is synthesized from the mirror: requests that streamed nothing
        are harvested for bit-exact requeue, requests caught mid-decode
        flush their streamed partial to the waiter (the in-process
        ``flush_partials`` split, reconstructed from this side of the
        wire)."""
        if not self._wire_dead():
            entries = self._call("evacuate",
                                 flush_partials=bool(flush_partials))
            now = self._clock.now()
            out = []
            with self._state_lock:
                for e in entries:
                    m = self._mirror.pop(e["rid"], None)
                    if m is not None:
                        m.done = True
                        self._journeys.pop(m.tid, None)
                    out.append(_Harvested(
                        e["rid"], np.asarray(e["ids"], np.int32),
                        e["budget"], e["seed"],
                        m.on_token if m is not None else None,
                        None if e.get("deadline_s") is None
                        else now + float(e["deadline_s"]),
                        e.get("priority") or 0,
                        m.journey if m is not None else None))
            return out
        out = []
        with self._state_lock:
            for rid, m in list(self._mirror.items()):
                if m.done:
                    continue
                self._mirror.pop(rid)
                m.done = True
                self._journeys.pop(m.tid, None)
                if m.tokens:
                    # mid-decode on the corpse: replaying elsewhere
                    # would double-stream — the partial is the result
                    self._results[rid] = np.asarray(
                        m.tokens[:m.budget], np.int32)
                    if m.journey is not None:
                        m.journey.event("flushed",
                                        tokens=len(self._results[rid]),
                                        synthesized=True)
                else:
                    out.append(_Harvested(rid, m.ids, m.budget, m.seed,
                                          m.on_token, m.deadline,
                                          m.priority, m.journey))
        return out

    def abandon(self, rid, err):
        try:
            return bool(self._call("abandon", rid=int(rid),
                                   err=marshal_error(err)))
        except (TransportError, TimeoutError):
            return False

    def postmortems(self):
        try:
            return self._call("postmortems") or []
        except (TransportError, TimeoutError):
            return []

    def pool_balance(self):
        """The remote pool's ``(free, live, pinned, cached)`` balance
        (None for a dense backend or an unreachable host) — the chaos
        suites' zero-leak probe, over the wire."""
        try:
            b = self._call("pool_balance")
        except (TransportError, TimeoutError):
            return None
        if b is None:
            return None
        from .continuous_batching import PoolBalance
        return PoolBalance(b["free"], b["live"], b["pinned"],
                           b["cached"], preempted=b["preempted"],
                           preemptions=b["preemptions"])

    def registry_snapshot(self):
        """The remote server's metric-registry snapshot (decoded to the
        local snapshot shape), or None — ``fleet_snapshot()`` merges it
        so ``/fleet`` spans process boundaries. Bounded by a SHORT
        reply timeout (`snapshot_timeout_s`, default 2 s), not the
        general call budget: a wedged host must cost a scrape one
        missing contributor, not a 30 s stall of the metrics server."""
        try:
            snap = self._call("snapshot",
                              reply_timeout=self.snapshot_timeout_s)
        except (TransportError, TimeoutError):
            return None
        return None if snap is None else decode_snapshot(snap)

    # --------------------------------------------------------- lifecycle
    def start(self):
        self._call("start")
        self._thread = "remote-serve"
        return self

    def stop(self, timeout=60.0, drain=False):
        try:
            self._call("stop", drain=bool(drain), timeout=timeout,
                       reply_timeout=float(timeout) + 5.0)
        except (TransportError, TimeoutError):
            if not self._wire_dead():
                raise       # host reachable but the stop itself failed
        self._thread = None

    def kill(self, timeout=60.0):
        """The POLITE kill (wire op): the remote server stops with its
        state intact, process alive — drills that need a real crash
        SIGKILL the spawned process instead."""
        try:
            self._call("kill", timeout=timeout,
                       reply_timeout=float(timeout) + 5.0)
        except (TransportError, TimeoutError):
            if not self._wire_dead():
                raise
        self._thread = None

    def shutdown(self):
        """Ask the host process to exit (reply first, then close), and
        close this client."""
        try:
            self._call("shutdown", reply_timeout=5.0)
        except (TransportError, TimeoutError):
            pass        # already gone: shutdown is idempotent
        self.close()

    def close(self):
        """Client-side teardown only (the host keeps serving others)."""
        self._closed = True
        with self._conn_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def __repr__(self):
        return (f"RemoteReplica({self.name}, health={self.health!r}, "
                f"mirrored={len(self._mirror)})")


# ------------------------------------------------------ process spawning
def _host_main(factory, factory_kwargs, pipe, host, heartbeat_s,
               start_server):
    """Child-process entry point: build the server from the picklable
    factory (on whatever device the factory names), serve it, report
    the bound port, park until shutdown."""
    server = factory(**(factory_kwargs or {}))
    h = ReplicaHost(server, host=host, port=0,
                    heartbeat_s=heartbeat_s).start()
    if start_server:
        server.start()
    pipe.send(h.port)
    pipe.close()
    h.wait_shutdown()


def spawn_replica_host(factory, factory_kwargs=None, host="127.0.0.1",
                       heartbeat_s=0.02, method="spawn",
                       start_server=False, startup_timeout=120.0):
    """Spawn a replica host in its OWN process: ``factory(**kwargs)``
    (a module-level, picklable callable) builds the
    ``ContinuousBatchingServer`` in the child. Returns
    ``(process, address)`` once the child reports its port — connect a
    ``RemoteReplica`` to ``address``, SIGKILL ``process`` to crash it
    for real. ``method`` is the multiprocessing start method
    (``"spawn"`` pays a fresh interpreter but never inherits CUDA
    state mid-flight).

    A process that has initialised CUDA cannot fork a child that uses
    it: ``method="fork"`` from such a parent raises ``TransportError``
    naming the reason, before any child starts. The children load the
    kernel libraries the parent (or ``build_all``) already built into
    the build directory; two children that find one missing build it
    side by side and agree through an atomic rename."""
    import multiprocessing as mp
    import sys
    ctx = mp.get_context(method)
    torch = sys.modules.get("torch")
    if ctx.get_start_method() == "fork" and torch is not None \
            and torch.cuda.is_initialized():
        raise TransportError(
            "spawn_replica_host(method='fork'): this process has "
            "initialised CUDA, and a forked child cannot use it (its "
            "first kernel launch would fail); use method='spawn'")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_host_main,
                       args=(factory, factory_kwargs, child, host,
                             heartbeat_s, start_server),
                       daemon=True)
    proc.start()
    child.close()
    try:
        if not parent.poll(startup_timeout):
            raise TransportError(
                f"replica host did not report a port within "
                f"{startup_timeout}s")
        port = parent.recv()
    except (TransportError, EOFError, OSError) as e:
        proc.kill()
        proc.join(5.0)
        err = TransportError(
            f"replica host child died before reporting a port "
            f"(exitcode={proc.exitcode})")
        if not isinstance(e, TransportError):
            err.__cause__ = e
        raise err
    finally:
        parent.close()
    return proc, (host, int(port))

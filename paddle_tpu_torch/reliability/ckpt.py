"""Durable (crash-safe) checkpoints for the training stack.

Port of ``paddle_tpu/reliability/ckpt.py``, with the same on-disk
format, so that a checkpoint written by either package verifies and
reads in the other. The state is flattened as ``jax.tree_util`` does it
(``_flatten``: dicts in sorted key order, an ``OrderedDict`` in its own
order, lists and tuples in order, ``None`` a node without a leaf), so
the leaves, their order and the integer skeleton are the reference's.

A checkpoint here is a DIRECTORY that either exists completely or not
at all, enforced with the classic write-ahead discipline:

1. every payload file is written into a hidden sibling TEMP dir;
2. each file is fsync'd; the manifest (per-file sha256 + byte counts +
   the caller's metadata) is written LAST, then fsync'd;
3. the temp dir itself is fsync'd, then atomically ``os.rename``d to
   the final name (``ckpt.rename`` is the commit point — a crash on
   either side leaves, respectively, an invisible temp dir or a fully
   durable checkpoint, never a half one);
4. the parent dir is fsync'd so the rename survives power loss.

``read_checkpoint`` re-hashes every payload file against the manifest
and raises the typed ``CheckpointCorruptError`` on ANY mismatch —
a torn write can never be silently loaded. ``CheckpointStore`` layers
step-numbered retention on top and, crucially, restores from the newest
checkpoint that VERIFIES, not the newest directory.

Payload format: the state tree is flattened; each leaf is pickled on
its own (through ``io.save_load``'s tensor/bf16 codec: numpy arrays
only, no torch object) into ``leaf_<i>.pkl`` so the manifest carries
PER-LEAF checksums; the container structure goes to ``skeleton.pkl``
(the tree with leaves replaced by indices) and the caller's metadata
(step, RNG state, data cursor, ...) to ``meta.pkl``. ``read_checkpoint``
returns tensors as torch CPU tensors (``io.load``'s decoding).

Fault-injection points: ``ckpt.write`` fires per payload file (and
leaves a genuinely TORN file behind — a prefix of the real bytes — so
chaos tests exercise the checksum path, not just clean absence);
``ckpt.rename`` fires at the commit point.
"""

import hashlib
import json
import os
import pickle
import re
import shutil
import threading
from collections import OrderedDict

import numpy as np
import torch

from . import faults as _faults
from .errors import CheckpointCorruptError

__all__ = ["write_checkpoint", "read_checkpoint", "verify_checkpoint",
           "checkpoint_meta", "recover_interrupted_swaps",
           "CheckpointStore", "AsyncCheckpointer",
           "MANIFEST_NAME"]

MANIFEST_NAME = "manifest.json"
_FORMAT = 1
_STEP_RE = re.compile(r"^step_(\d+)$")


def _sha256(data):
    return hashlib.sha256(data).hexdigest()


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    # directory fsync makes the entries durable; some filesystems
    # refuse O_RDONLY fsync on dirs — degrade quietly, the rename is
    # still atomic wrt. crashes of THIS process
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _encode_leaf(obj):
    from ..io.save_load import _encode
    return pickle.dumps(_encode(obj), protocol=4)


def _decode_leaf(data):
    from ..io.save_load import _decode
    return _decode(pickle.loads(data))


def _flatten(state):
    """``(leaves, skeleton)`` as ``jax.tree_util.tree_flatten`` orders
    them: the skeleton is ``state`` with each leaf replaced by its
    index in ``leaves``."""
    leaves = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, OrderedDict):
            return OrderedDict((k, walk(x[k])) for k in x)
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[walk(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        leaves.append(x)
        return len(leaves) - 1

    skeleton = walk(state)
    return leaves, skeleton


def _unflatten(skeleton, leaves):
    """The tree ``skeleton`` with each index replaced by its leaf."""
    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[walk(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return leaves[x]

    return walk(skeleton)


def _tree_map(fn, state):
    """``fn`` applied to every leaf of ``state``, in the tree's order."""
    leaves, skeleton = _flatten(state)
    return _unflatten(skeleton, [fn(x) for x in leaves])


def _torn_write(path, payload, fired):
    """Write ``payload`` to ``path``; when the injector fired, leave a
    TORN file (a strict prefix) behind and re-raise — simulating the
    process dying mid-write."""
    if fired is None:
        with open(path, "wb") as f:
            f.write(payload)
        return
    with open(path, "wb") as f:
        f.write(payload[:max(1, len(payload) // 2)])
        f.flush()
    raise fired


def write_checkpoint(path, state, meta=None, *, step=None, injector=None,
                     fsync=True, overwrite=False):
    """Atomically persist ``state`` (a pytree) + ``meta`` (a picklable
    dict) at directory ``path``. Returns the manifest dict. The
    checkpoint only becomes visible under its final name after every
    byte (payloads AND manifest) is durable."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"checkpoint already exists: {path}")
    tmp = os.path.join(parent,
                       f".{os.path.basename(path)}.tmp.{os.getpid()}."
                       f"{threading.get_ident()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, skeleton = _flatten(state)
    manifest = {"format": _FORMAT, "step": step,
                "num_leaves": len(leaves), "files": {}}

    def put(name, payload):
        fired = None
        if injector is not None:
            try:
                injector.check(_faults.CKPT_WRITE, file=name)
            except Exception as e:
                fired = e
        _torn_write(os.path.join(tmp, name), payload, fired)
        if fsync:
            _fsync_file(os.path.join(tmp, name))
        manifest["files"][name] = {"sha256": _sha256(payload),
                                   "bytes": len(payload)}

    for i, leaf in enumerate(leaves):
        put(f"leaf_{i:05d}.pkl", _encode_leaf(leaf))
    put("skeleton.pkl", pickle.dumps(skeleton, protocol=4))
    put("meta.pkl", _encode_leaf(dict(meta or {})))
    mpath = os.path.join(tmp, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    if fsync:
        _fsync_file(mpath)
        _fsync_dir(tmp)
    if injector is not None:
        injector.check(_faults.CKPT_RENAME, path=path)
    if os.path.exists(path):
        # overwrite=True: crash-safe swap. Park the old checkpoint
        # under a deterministic '.<name>.old' trash name, promote the
        # new one, then delete the trash. A crash inside the window
        # (old parked, new not yet live) is healed by
        # recover_interrupted_swaps: the parked — still fully valid —
        # checkpoint is renamed back, so the swap never LOSES a
        # checkpoint, it only ever keeps old or new.
        trash = os.path.join(parent,
                             "." + os.path.basename(path) + ".old")
        if os.path.exists(trash):
            shutil.rmtree(trash)
        os.rename(path, trash)
        if injector is not None:
            injector.check(_faults.CKPT_SWAP, path=path)
        os.rename(tmp, path)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.rename(tmp, path)
    if fsync:
        _fsync_dir(parent)
    return manifest


def warn_if_foreign_dir(directory, owner, resolution, stacklevel=4):
    """``directory`` has no durable checkpoint but is not empty — most
    likely checkpoints in a format this store cannot read (e.g. written
    before the durable layer existed). Restarting silently would read
    as 'fresh run' and discard that work, so warn loudly instead.
    Shared by every store-backed front end (CheckpointManager,
    TrainEpochRange) so the detection rule lives in one place."""
    import warnings
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    foreign = [n for n in entries
               if not n.startswith(".") and not _STEP_RE.match(n)]
    if foreign:
        warnings.warn(
            f"{owner} found no durable checkpoint in {directory!r} but "
            f"it contains {len(foreign)} unrecognized entries (e.g. "
            f"{foreign[0]!r}) — possibly checkpoints from a pre-durable "
            f"format, which this store cannot read; {resolution}",
            RuntimeWarning, stacklevel=stacklevel)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True              # EPERM: exists, owned by someone else
    return True


def recover_interrupted_swaps(directory):
    """Heal overwrite swaps cut short by a crash: a ``.<name>.old``
    trash dir whose final name is ABSENT is the old checkpoint parked
    mid-swap — rename it back into place; one whose final name exists
    belongs to a completed swap — delete it. Returns the recovered
    final names."""
    recovered = []
    for name in os.listdir(directory):
        if not (name.startswith(".") and name.endswith(".old")):
            continue
        final = name[1:-len(".old")]
        trash = os.path.join(directory, name)
        if os.path.exists(os.path.join(directory, final)):
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(trash, os.path.join(directory, final))
            recovered.append(final)
    return recovered


def _read_manifest(path):
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.isdir(path):
        raise CheckpointCorruptError(path, "not a directory")
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(path, "missing manifest")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(path, f"unreadable manifest: {e}")
    if manifest.get("format") != _FORMAT:
        raise CheckpointCorruptError(
            path, f"unknown format {manifest.get('format')!r}")
    return manifest


def _verified_bytes(path, name, entry):
    fpath = os.path.join(path, name)
    if not os.path.exists(fpath):
        raise CheckpointCorruptError(path, f"missing file {name}")
    with open(fpath, "rb") as f:
        data = f.read()
    if len(data) != entry["bytes"]:
        raise CheckpointCorruptError(
            path, f"{name}: size {len(data)} != manifest {entry['bytes']}")
    if _sha256(data) != entry["sha256"]:
        raise CheckpointCorruptError(path, f"{name}: checksum mismatch")
    return data


def verify_checkpoint(path):
    """Full integrity pass (manifest + every payload checksum); raises
    ``CheckpointCorruptError``, returns the manifest when clean."""
    path = os.path.abspath(path)
    manifest = _read_manifest(path)
    for name, entry in manifest["files"].items():
        _verified_bytes(path, name, entry)
    return manifest


def checkpoint_meta(path):
    """The saved ``meta`` dict alone (verified) — cheap resume-cursor
    peeking without deserializing model state."""
    path = os.path.abspath(path)
    manifest = _read_manifest(path)
    data = _verified_bytes(path, "meta.pkl", manifest["files"]["meta.pkl"])
    return _decode_leaf(data)


def read_checkpoint(path, verify=True):
    """Load ``(state, meta)``; every file is checksum-verified before a
    single byte is deserialized (``verify=False`` skips hashing for
    trusted local re-reads)."""
    path = os.path.abspath(path)
    manifest = _read_manifest(path)

    verified = {}
    if verify:                  # one hash pass; blob() reuses the bytes
        for name, entry in manifest["files"].items():
            verified[name] = _verified_bytes(path, name, entry)

    def blob(name):
        if name in verified:
            return verified[name]
        if manifest["files"].get(name) is None:
            raise CheckpointCorruptError(path, f"manifest missing {name}")
        with open(os.path.join(path, name), "rb") as f:
            return f.read()

    try:
        skeleton = pickle.loads(blob("skeleton.pkl"))
        leaves = [_decode_leaf(blob(f"leaf_{i:05d}.pkl"))
                  for i in range(manifest["num_leaves"])]
        meta = _decode_leaf(blob("meta.pkl"))
    except CheckpointCorruptError:
        raise
    except Exception as e:         # torn pickle that still hashed clean
        raise CheckpointCorruptError(path, f"undecodable payload: {e}")
    return _unflatten(skeleton, leaves), meta


class CheckpointStore:
    """Step-numbered durable checkpoints under one directory.

    - ``save(step, state, meta)``: atomic write to ``step_<k>``; prunes
      stale temp dirs from crashed saves, then applies retention.
    - ``restore(step=None)``: explicit step -> verify or raise; latest
      (default) -> walk newest-to-oldest, SKIP corrupt dirs, land on
      the newest checkpoint that passes checksums. Corrupt dirs are
      counted (``ckpt_corrupt_total``) and reported in ``.skipped``.
    - retention: keep the newest ``max_to_keep`` VALID checkpoints;
      corrupt/newer-but-torn dirs never push a valid one out, and the
      newest valid checkpoint is never deleted.

    The telemetry of the reference (``ckpt_save_seconds`` /
    ``ckpt_restore_seconds`` histograms, ``ckpt_last_good_step`` gauge,
    ``ckpt_corrupt_total`` counter) waits for the port's telemetry:
    ``registry=`` raises ``NotImplementedError`` (ROADMAP Queue 1 item
    8).
    """

    _STEP_RE = _STEP_RE

    def __init__(self, directory, max_to_keep=None, fsync=True,
                 injector=None, registry=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.fsync = fsync
        self.injector = injector
        self.skipped = []             # (step, reason) from restore scans
        self._lock = threading.Lock()
        # step -> bool: validity at last full hash (saves this instance
        # committed are known-valid; restore() re-hashes regardless and
        # refreshes entries, so externally corrupted dirs are demoted
        # the moment recovery actually looks at them)
        self._valid_cache = {}
        if registry is not None:
            raise NotImplementedError(
                "CheckpointStore(registry=...): the telemetry registry is "
                "not ported yet (ROADMAP Queue 1 item 8)")
        recover_interrupted_swaps(self.directory)

    # ------------------------------------------------------------ paths
    def step_path(self, step):
        return os.path.join(self.directory, f"step_{int(step):010d}")

    def all_steps(self):
        """Committed step numbers, ascending (no validity check)."""
        out = []
        for name in os.listdir(self.directory):
            m = self._STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _is_valid(self, s):
        v = self._valid_cache.get(s)
        if v is None:
            try:
                verify_checkpoint(self.step_path(s))
                v = True
            except CheckpointCorruptError:
                v = False
            self._valid_cache[s] = v
        return v

    def valid_steps(self):
        """Steps whose checkpoints pass full verification, ascending
        (hash results are cached per step — a save-heavy loop does not
        re-hash its whole history every save)."""
        return [s for s in self.all_steps() if self._is_valid(s)]

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_valid_step(self):
        for s in reversed(self.all_steps()):
            if self._is_valid(s):
                return s
        return None

    # ------------------------------------------------------------- save
    def _sweep_tmp(self):
        """Heal interrupted overwrite swaps, then remove temp dirs
        abandoned by crashed/injected saves. A temp dir whose embedded
        pid is a DIFFERENT, still-live process is left alone: during a
        preemption handover the replacement trainer must not delete the
        old trainer's in-flight final save out from under its rename
        (the swap-heal window itself still assumes one writer at a
        time — concurrent writers sharing a directory are unsupported)."""
        recover_interrupted_swaps(self.directory)
        for name in os.listdir(self.directory):
            if not (name.startswith(".") and ".tmp." in name):
                continue
            m = re.search(r"\.tmp\.(\d+)\.", name)
            pid = int(m.group(1)) if m else None
            if pid is not None and pid != os.getpid() and _pid_alive(pid):
                continue
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)

    def save(self, step, state, meta=None):
        """Durably commit ``state``+``meta`` as ``step``; returns the
        checkpoint path. Raises whatever the injected fault / OS error
        was — an aborted save leaves NO visible checkpoint (the torn
        temp dir is swept on the next save)."""
        step = int(step)
        with self._lock:
            self._sweep_tmp()
            meta = dict(meta or {})
            meta.setdefault("step", step)
            write_checkpoint(self.step_path(step), state, meta, step=step,
                             injector=self.injector, fsync=self.fsync,
                             overwrite=True)
            self._valid_cache[step] = True
            self._prune()
            return self.step_path(step)

    def _prune(self):
        if self.max_to_keep is None or self.max_to_keep <= 0:
            return
        valid = self.valid_steps()
        keep = set(valid[-self.max_to_keep:])
        for s in self.all_steps():
            if s in keep:
                continue
            if valid and s == valid[-1]:
                continue               # never delete the newest valid
            shutil.rmtree(self.step_path(s), ignore_errors=True)
            self._valid_cache.pop(s, None)

    # ---------------------------------------------------------- restore
    def restore(self, step=None):
        """``(state, meta, step)``. Explicit ``step``: verify-or-raise.
        Default: newest VALID checkpoint (corrupt dirs are skipped and
        recorded); returns ``(None, None, None)`` when the store holds
        no valid checkpoint at all.

        Serialized against ``save`` by the store lock — healing an
        interrupted swap must never race a save that is legitimately
        INSIDE its swap window on another thread (async saves)."""
        with self._lock:
            return self._restore_locked(step)

    def _restore_locked(self, step):
        recover_interrupted_swaps(self.directory)
        if step is not None:
            state, meta = read_checkpoint(self.step_path(step))
            return state, meta, int(step)
        self.skipped = []
        for s in reversed(self.all_steps()):
            try:
                state, meta = read_checkpoint(self.step_path(s))
            except CheckpointCorruptError as e:
                self.skipped.append((s, str(e)))
                self._valid_cache[s] = False
                continue
            self._valid_cache[s] = True
            return state, meta, s
        return None, None, None


class AsyncCheckpointer:
    """Background-thread saves over a ``CheckpointStore`` with bounded
    in-flight work and a hard barrier against overlapping saves.

    ``save()`` SNAPSHOTS the state to the host synchronously (the caller
    may update its tensors in place the moment we return) and
    hands serialization + fsync + rename to the worker. At most
    ``max_pending`` snapshots queue; a further ``save()`` blocks until
    the worker drains one — backpressure, not unbounded memory. The
    store's lock already serializes the writes themselves, so two saves
    can never interleave inside one directory.

    A failed background save is sticky: the NEXT ``save()`` / ``wait()``
    re-raises it (chaos tests assert the torn attempt stayed invisible).
    """

    def __init__(self, store, max_pending=1):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.store = store
        self._sem = threading.Semaphore(max_pending)
        self._jobs = []
        self._jobs_lock = threading.Lock()
        self._error = None
        self._closed = False

    @staticmethod
    def _snapshot(state):
        def host(x):
            # COPIES: a leaf the caller updates in place right after
            # submit must not leak into the snapshot (a CPU tensor's
            # .cpu() would be the tensor itself)
            if isinstance(x, torch.Tensor):
                return x.detach().to("cpu", copy=True)
            if isinstance(x, np.ndarray):
                return np.array(x)
            return x
        return _tree_map(host, state)

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step, state, meta=None):
        """Queue a durable save of a host snapshot of ``state``; blocks
        only when ``max_pending`` saves are already in flight."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_pending()
        snap = self._snapshot(state)
        meta = self._snapshot(dict(meta or {}))
        self._sem.acquire()

        def work():
            try:
                self.store.save(step, snap, meta)
            except Exception as e:
                if self._error is None:   # keep the FIRST failure (root
                    self._error = e       # cause), not the latest
            finally:
                self._sem.release()

        t = threading.Thread(target=work, name=f"ckpt-save-{step}",
                             daemon=True)
        with self._jobs_lock:
            self._jobs = [j for j in self._jobs if j.is_alive()]
            self._jobs.append(t)
        t.start()
        return t

    def wait(self):
        """Barrier: block until every queued save is durable; re-raise
        the first background failure, if any."""
        with self._jobs_lock:
            jobs = list(self._jobs)
        for t in jobs:
            t.join()
        self._raise_pending()

    def close(self):
        self._closed = True
        self.wait()

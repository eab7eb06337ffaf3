"""Step-numbered checkpoints with retention over the durable store.

Port of ``paddle_tpu/io/checkpoint.py``. ``CheckpointManager`` rides the
crash-safe durable layer in ``reliability/ckpt.py`` (manifest with
per-leaf checksums, fsync + atomic rename, newest-VALID restore
fallback) so a kill at any instant never loses the training run; its
directories are the reference's format. ``save_sharded``,
``load_sharded`` and ``checkpoint_meta_tree`` are orbax checkpoints of
sharded arrays in the reference: they raise ``NotImplementedError``
(ROADMAP Queue 1 item 13, multi-card training).
"""
import os

__all__ = ["CheckpointManager", "save_sharded", "load_sharded",
           "checkpoint_meta_tree"]


def _sharded(what):
    raise NotImplementedError(
        f"io.{what}: orbax checkpoints of sharded arrays are not ported "
        f"yet (ROADMAP Queue 1 item 13)")


def save_sharded(state, path, overwrite=True):
    _sharded("save_sharded")


def checkpoint_meta_tree(path):
    _sharded("checkpoint_meta_tree")


def load_sharded(path, target=None, shardings=None):
    _sharded("load_sharded")


class CheckpointManager:
    """Step-numbered checkpoints with retention + async save
    (fleet auto-checkpoint parity, reference auto_checkpoint.py).

    Backed by the durable-checkpoint layer (reliability/ckpt.py):
    every save is checksummed, fsync'd, and committed by atomic rename,
    so a manager directory NEVER contains a half-written checkpoint
    under a final name; ``restore()`` (latest) lands on the newest
    checkpoint that passes verification, skipping corrupt dirs.

    Retention semantics (regression-tested):
    - ``save_interval_steps``: off-interval steps are SKIPPED (``save``
      returns False) and do not count against ``max_to_keep``;
    - ``max_to_keep`` counts VALID checkpoints only, and the newest
      valid checkpoint always survives pruning.

    ``async_save`` defaults to False: synchronous save-then-return is
    the safe default for the durability contract — "save() returned"
    means "this step survives a kill"; ``async_save=True`` moves
    serialization+fsync off the step path. ``registry=`` raises
    ``NotImplementedError`` (ROADMAP Queue 1 item 8).
    """

    def __init__(self, directory, max_to_keep=3, save_interval_steps=1,
                 async_save=False, fsync=True, fault_injector=None,
                 registry=None):
        from ..reliability.ckpt import AsyncCheckpointer, CheckpointStore
        self._dir = os.path.abspath(directory)
        self.save_interval_steps = int(save_interval_steps)
        self._store = CheckpointStore(self._dir, max_to_keep=max_to_keep,
                                      fsync=fsync, injector=fault_injector,
                                      registry=registry)
        self._async = (AsyncCheckpointer(self._store) if async_save
                       else None)

    @property
    def store(self):
        return self._store

    def should_save(self, step):
        return int(step) % self.save_interval_steps == 0

    def save(self, step, state, metrics=None, force=False):
        """Durably save ``state`` at ``step`` when it lands on the save
        interval (or ``force=True``). Returns True when a checkpoint
        was (queued to be) written, False when the step was skipped."""
        if not force and not self.should_save(step):
            return False
        meta = {"step": int(step)}
        if metrics is not None:
            meta["metrics"] = metrics
        if self._async is not None:
            self._async.save(step, state, meta)
        else:
            self._store.save(step, state, meta)
        return True

    def restore(self, step=None, target=None):
        """Latest-valid (default) or explicit-step state; ``None`` when
        the directory has no valid checkpoint (or the requested step
        was never saved). ``target`` is accepted
        for orbax-API compatibility only — it cannot be honored (the
        pickle codec restores host tensors without resharding), so
        passing one warns rather than silently dropping it."""
        if target is not None:
            import warnings
            warnings.warn(
                "CheckpointManager.restore(target=...) is ignored: the "
                "durable-layer codec restores plain host tensors and "
                "cannot reshard onto a target.",
                RuntimeWarning, stacklevel=2)
        self.wait_until_finished()
        if step is not None:
            if not os.path.isdir(self._store.step_path(step)):
                return None              # plain absence is not corruption
            state, _meta, _ = self._store.restore(step=step)
            return state
        state, _meta, found = self._store.restore()
        if found is None:
            self._warn_if_foreign()
        return state if found is not None else None

    def _warn_if_foreign(self):
        _dur().warn_if_foreign_dir(
            self._dir, "CheckpointManager",
            "restore() is treating this as a fresh start.")

    def metrics(self, step):
        """The ``metrics`` dict recorded at ``step`` — None when the
        step has no checkpoint or recorded no metrics. A checkpoint
        that EXISTS but fails verification still raises
        ``CheckpointCorruptError`` (corruption stays loud)."""
        self.wait_until_finished()
        path = self._store.step_path(step)
        if not os.path.isdir(path):
            return None
        meta = _dur().checkpoint_meta(path)
        return meta.get("metrics")

    def latest_step(self):
        self.wait_until_finished()
        return self._store.latest_valid_step()

    def all_steps(self):
        self.wait_until_finished()
        return self._store.valid_steps()

    def wait_until_finished(self):
        if self._async is not None:
            self._async.wait()

    def close(self):
        if self._async is not None:
            self._async.close()


def _dur():
    from ..reliability import ckpt as _ckpt
    return _ckpt

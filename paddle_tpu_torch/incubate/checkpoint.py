"""Auto-checkpoint for preemptible jobs: ``TrainEpochRange`` /
``train_epoch_range``.

Port of ``paddle_tpu/incubate/checkpoint.py``. Each epoch's snapshot
is one durable checkpoint committed through the port's
``reliability.ckpt.CheckpointStore`` (checksums, fsync, atomic rename,
retention of one), keyed by epoch: the resume epoch is the store's newest
snapshot that passes verification, so a kill at any instant neither
re-runs a completed epoch nor skips an unfinished one.
"""
import os

__all__ = ["TrainEpochRange", "train_epoch_range"]


def _ckpt_root():
    return os.environ.get("PADDLE_CHECKPOINT_DIR", "./auto_checkpoint")


class TrainEpochRange:
    """Iterate epochs ``restored_from() + 1 .. max_epoch_num - 1``,
    saving every registered object's ``state_dict()`` after each
    ``save_checkpoint_inter``-th epoch; objects registered with ``add``
    are restored from the resume snapshot when there is one."""

    def __init__(self, max_epoch_num, name, save_checkpoint_inter=1,
                 checkpoint_dir=None, fault_injector=None):
        from ..reliability.ckpt import CheckpointStore, warn_if_foreign_dir
        self.name = name
        self.max_epoch_num = max_epoch_num
        self.save_inter = save_checkpoint_inter
        self.dir = os.path.join(checkpoint_dir or _ckpt_root(), name)
        self.store = CheckpointStore(self.dir, max_to_keep=1,
                                     injector=fault_injector)
        self._objs = {}
        self._restored_state = None      # the resume snapshot, read lazily
        latest = self.store.latest_valid_step()
        self._epoch = -1 if latest is None else latest
        if latest is None:
            warn_if_foreign_dir(self.dir, f"TrainEpochRange({self.name!r})",
                                "resuming from epoch 0.", stacklevel=3)

    def restored_from(self):
        return self._epoch

    def add(self, name, obj):
        """Register a state-dict object (a model, an optimizer); its state
        comes back from the resume snapshot when there is one."""
        self._objs[name] = obj
        if self._epoch >= 0:
            if self._restored_state is None:
                self._restored_state, _, _ = self.store.restore(
                    step=self._epoch)
            if name in self._restored_state:
                obj.set_state_dict(self._restored_state[name])
        return self

    def save(self, epoch):
        """Commit epoch ``epoch``'s snapshot; only a committed snapshot
        moves the resume point."""
        state = {name: obj.state_dict() for name, obj in self._objs.items()}
        self.store.save(epoch, state, {"epoch": epoch})
        self._epoch = epoch

    def __iter__(self):
        for epoch in range(self._epoch + 1, self.max_epoch_num):
            yield epoch
            if (epoch + 1) % self.save_inter == 0:
                self.save(epoch)


def train_epoch_range(max_epoch_num, name="auto_ckpt",
                      save_checkpoint_inter=1):
    return TrainEpochRange(max_epoch_num, name, save_checkpoint_inter)

"""Dataset / DataLoader / samplers.

Port of ``paddle_tpu/io/dataloader.py`` (itself paddle.io's Dataset,
DataLoader with multiprocess workers over a shared-memory queue, and
DistributedBatchSampler): host-side numpy batching, which the caller
(``hapi.Model``) moves to the card once a step. Every random draw is
numpy's, made where the reference makes it (the samplers, the workers'
seeds from ``np.random.randint`` in the parent), so the same numpy seed
and epoch give the reference's batch order.

Workers are forked processes, as in the reference. They run the dataset
and the collate function only and never touch CUDA, so a loader may
start them after the card is in use; torch CPU tensors (bf16 too) cross
to the parent through shared memory like numpy arrays.
``use_native_ring=True`` (the reference's C++
``runtime.ShmRing`` transport) raises ``NotImplementedError`` (ROADMAP
Queue 1 item 15); ``DistributedBatchSampler(num_replicas=None)`` means
one replica, as the reference resolves it without a mesh (the port has
no mesh: ROADMAP Queue 1 item 13).
"""
import math
import multiprocessing

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "random_split", "ComposeDataset", "ChainDataset", "DataLoader",
           "BatchSampler", "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler",
           "DistributedBatchSampler", "default_collate_fn", "get_worker_info"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    if sum(lengths) != n:
        # fractional lengths
        if all(0 < l < 1 for l in lengths):
            lengths = [int(l * n) for l in lengths]
            lengths[-1] = n - sum(lengths[:-1])
        else:
            raise ValueError("lengths must sum to dataset size")
    perm = np.random.permutation(n)
    out, ofs = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + l].tolist()))
        ofs += l
    return out


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """Sample indices with given per-sample weights (reference
    python/paddle/io WeightedRandomSampler)."""

    def __init__(self, weights, num_samples, replacement=True):
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        if not replacement and num_samples > len(weights):
            raise ValueError(
                "num_samples exceeds population for replacement=False")
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = int(num_samples)
        self.replacement = bool(replacement)

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(p), size=self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Reference: python/paddle/io DistributedBatchSampler — shard indices by
    dp rank. ``num_replicas`` defaults to 1 and ``rank`` to 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None:
            num_replicas = 1
        self.nranks = num_replicas
        self.local_rank = rank or 0
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:self.total_size - len(indices)]
        local = indices[self.local_rank::self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class _WorkerInfo:
    def __init__(self, id_, num_workers, dataset):
        self.id = id_
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    return _worker_info


def default_collate_fn(batch):
    """Stack samples into batched numpy arrays / CPU tensors."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


# --------------------------------------------- multiprocess worker plumbing

class _ShmRef:
    """Pickle-light reference to a numpy array parked in POSIX shared
    memory (reference: dataloader_iter.py:162 shared-mem worker queue —
    large batches cross the process boundary as a name + memcpy, never
    through pickle serialization). ``tensor``: the torch dtype of a CPU
    tensor parked as its bytes (bf16 as int16), which comes back as a
    tensor; None for a numpy array."""

    __slots__ = ("name", "shape", "dtype", "tensor")

    def __init__(self, name, shape, dtype, tensor=None):
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.tensor = tensor


def _tree_to_shm(obj):
    from multiprocessing import resource_tracker, shared_memory
    tensor = obj.dtype if isinstance(obj, torch.Tensor) else None
    if tensor is not None:
        obj = obj.contiguous()
        obj = (obj.view(torch.int16) if tensor == torch.bfloat16
               else obj).numpy()
    if isinstance(obj, np.ndarray) and obj.nbytes > 0:
        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        np.frombuffer(shm.buf, obj.dtype)[:obj.size] = obj.reshape(-1)
        ref = _ShmRef(shm.name, obj.shape, obj.dtype, tensor)
        shm.close()  # worker-side handle; parent unlinks after reading
        # the parent owns the segment from here: the worker's resource
        # tracker must not "clean up" (and warn about) what it unlinks
        resource_tracker.unregister(shm._name, "shared_memory")
        return ref
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_shm(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _tree_to_shm(v) for k, v in obj.items()}
    return obj


def _tree_from_shm(obj):
    from multiprocessing import shared_memory
    if isinstance(obj, _ShmRef):
        shm = shared_memory.SharedMemory(name=obj.name)
        try:
            arr = np.frombuffer(shm.buf, obj.dtype)[
                :int(np.prod(obj.shape))].reshape(obj.shape).copy()
        finally:
            shm.close()
            shm.unlink()
        if obj.tensor is None:
            return arr
        return torch.from_numpy(arr).view(obj.tensor)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_from_shm(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _tree_from_shm(v) for k, v in obj.items()}
    return obj


def _worker_loop(dataset, index_queue, result_queue, collate_fn, wid,
                 num_workers, worker_init_fn, use_shared_memory, seed):
    """Worker process body (reference _worker_loop, dataloader/worker.py)."""
    global _worker_info
    _worker_info = _WorkerInfo(wid, num_workers, dataset)
    # a forked child must not start torch's intra-op thread pool (the
    # parent's does not survive the fork); one thread, as torch's own
    # loader workers run
    torch.set_num_threads(1)
    np.random.seed((seed + wid) % (2 ** 31))
    if worker_init_fn is not None:
        worker_init_fn(wid)
    while True:
        item = index_queue.get()
        if item is None:
            break
        epoch, bidx, indices = item
        try:
            batch = collate_fn([dataset[i] for i in indices])
            if use_shared_memory:
                batch = _tree_to_shm(batch)
            result_queue.put((epoch, bidx, True, batch))
        except Exception:
            import traceback
            result_queue.put((epoch, bidx, False, traceback.format_exc()))


class DataLoader:
    """paddle.io.DataLoader parity. num_workers>0 spawns REAL worker
    processes (fork) with per-worker index queues and a shared result
    queue; use_shared_memory routes numpy payloads through POSIX shared
    memory instead of pickle (reference
    python/paddle/fluid/dataloader/dataloader_iter.py:162,370)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_native_ring=False,
                 ring_slot_mb=8):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        if use_native_ring:
            raise NotImplementedError(
                "DataLoader(use_native_ring=True): the native shared-memory "
                "ring (runtime.ShmRing) is not ported yet (ROADMAP Queue 1 "
                "item 15)")
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
        self.prefetch_factor = prefetch_factor
        self._workers = []
        self._index_queues = []
        self._result_queue = None
        self._epoch = 0

    def __len__(self):
        return len(self.batch_sampler)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def resume_iter(self, skip):
        """Batches starting at batch index ``skip`` — mid-epoch exact
        resume. Single-process map-style loaders skip by consuming only
        the sampler's index lists (no ``__getitem__``/collate for the
        already-trained prefix, so resume cost is independent of the
        position in the epoch); iterable datasets and multiprocess
        loaders fall back to fetch-and-discard."""
        if skip <= 0:
            yield from self
            return
        if isinstance(self.dataset, IterableDataset) or self.num_workers > 0:
            it = iter(self)
            for _ in range(skip):
                try:
                    next(it)
                except StopIteration:
                    return
            yield from it
            return
        for i, indices in enumerate(self.batch_sampler):
            if i >= skip:
                yield self._fetch(indices)

    # ---------------------------------------------------- worker control
    def _start_workers(self):
        ctx = multiprocessing.get_context("fork")
        self._result_queue = ctx.Queue()
        for wid in range(self.num_workers):
            iq = ctx.Queue()
            p = ctx.Process(
                target=_worker_loop,
                args=(self.dataset, iq, self._result_queue,
                      self.collate_fn, wid, self.num_workers,
                      self.worker_init_fn, self.use_shared_memory,
                      np.random.randint(0, 2 ** 31)),
                daemon=True)
            p.start()
            self._workers.append(p)
            self._index_queues.append(iq)

    def _drain_result_queue(self):
        """Unlink any parked shared-memory payloads so abandoned epochs
        and error paths don't leak /dev/shm segments."""
        import queue as queue_mod
        if self._result_queue is None:
            return
        while True:
            try:
                item = self._result_queue.get_nowait()
            except (queue_mod.Empty, OSError, ValueError):
                return
            payload = item[-1]
            if item[-2]:  # ok flag: payload may hold shm refs
                try:
                    _tree_from_shm(payload)
                except Exception:
                    pass

    def _shutdown_workers(self):
        for iq in self._index_queues:
            try:
                iq.put(None)
            except (OSError, ValueError):
                pass
        self._drain_result_queue()
        for p in self._workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._drain_result_queue()
        self._workers, self._index_queues = [], []
        self._result_queue = None

    def __del__(self):
        try:
            self._shutdown_workers()
        except Exception:
            pass

    # ------------------------------------------------------------- iter
    def __iter__(self):
        if isinstance(self.dataset, IterableDataset):
            yield from self._iter_iterable()
            return
        if self.num_workers <= 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        yield from self._iter_multiprocess()

    def _iter_multiprocess(self):
        import time as time_mod
        import queue as queue_mod
        if not self._workers:
            self._start_workers()
        self._epoch += 1
        epoch = self._epoch
        batches = list(self.batch_sampler)
        # bounded dispatch (reference: prefetch_factor * num_workers
        # outstanding batches) — no unbounded /dev/shm buildup when the
        # consumer is slower than the workers
        window = max(2, self.prefetch_factor) * self.num_workers
        next_submit = 0

        def submit_upto(n):
            nonlocal next_submit
            while next_submit < min(n, len(batches)):
                self._index_queues[next_submit % self.num_workers].put(
                    (epoch, next_submit, batches[next_submit]))
                next_submit += 1

        submit_upto(window)
        pending = {}
        try:
            for want in range(len(batches)):
                deadline = (time_mod.monotonic() + self.timeout
                            if self.timeout else None)
                while want not in pending:
                    try:
                        # poll so dead workers / user timeout are noticed
                        # even though timeout=0 means wait-forever
                        ep, bidx, ok, payload = self._result_queue.get(
                            timeout=5.0)
                    except queue_mod.Empty:
                        dead = [i for i, p in enumerate(self._workers)
                                if not p.is_alive()]
                        if dead:
                            self._shutdown_workers()
                            raise RuntimeError(
                                f"DataLoader workers died: {dead}")
                        if deadline and time_mod.monotonic() > deadline:
                            self._shutdown_workers()
                            raise RuntimeError(
                                f"DataLoader timed out after "
                                f"{self.timeout}s waiting for batch "
                                f"{want}")
                        continue
                    if not ok:
                        self._shutdown_workers()
                        raise RuntimeError(
                            f"DataLoader worker failed:\n{payload}")
                    if self.use_shared_memory:
                        payload = _tree_from_shm(payload)
                    if ep != epoch:
                        continue  # stale result from an abandoned epoch
                    pending[bidx] = payload
                submit_upto(want + 1 + window)
                yield pending.pop(want)
        finally:
            if not self.persistent_workers:
                self._shutdown_workers()

    def _iter_iterable(self):
        batch = []
        bs = self.batch_sampler.batch_size
        for item in self.dataset:
            batch.append(item)
            if len(batch) == bs:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.batch_sampler.drop_last:
            yield self.collate_fn(batch)

"""The port's ``io`` (datasets, samplers, ``DataLoader``, ``save`` /
``load``) against the JAX package's, on the CPU.

- every sampler draws from numpy's global RNG where the reference does,
  so after the same ``np.random.seed`` the batch orders are equal, over
  several epochs of ``DistributedBatchSampler`` (each epoch seeded by
  its number), shuffled ``BatchSampler``s, ``WeightedRandomSampler``
  and ``random_split``;
- ``DataLoader`` with 2 fork workers (over shared memory) yields the
  batches it yields in-process, which are the reference's; the parent's
  numpy stream moves as the reference's does (one ``randint`` a
  worker); ``resume_iter(k)`` yields exactly the batches from k on;
- ``io.save`` files load in both packages, bf16 exactly (stored as a
  tagged f32 array), and ``io.load`` returns torch CPU tensors;
- refusals name their ROADMAP item.
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch import io as tio


def _data(n=23, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = rng.integers(0, 5, (n, 1))
    return x, y


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x if isinstance(x, (list, tuple)) else (x,)
        y = y if isinstance(y, (list, tuple)) else (y,)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("nranks,rank,shuffle,drop_last", [
    (1, 0, True, False), (1, 0, False, False), (2, 1, True, True),
    (3, 2, True, False)])
def test_distributed_batch_sampler_epochs_equal_reference(nranks, rank,
                                                          shuffle,
                                                          drop_last):
    ds = list(range(23))
    j = jio.DistributedBatchSampler(ds, 4, num_replicas=nranks, rank=rank,
                                    shuffle=shuffle, drop_last=drop_last)
    t = tio.DistributedBatchSampler(ds, 4, num_replicas=nranks, rank=rank,
                                    shuffle=shuffle, drop_last=drop_last)
    assert len(t) == len(j)
    orders = []
    for epoch in range(3):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        assert list(t) == list(j)
        orders.append(list(t))
    if shuffle:
        assert orders[0] != orders[1]


def test_distributed_batch_sampler_defaults_to_one_replica():
    t = tio.DistributedBatchSampler(list(range(10)), 3)
    assert (t.nranks, t.local_rank) == (1, 0)
    assert list(t) == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]


@pytest.mark.parametrize("make", [
    lambda io, ds: io.BatchSampler(ds, shuffle=True, batch_size=4),
    lambda io, ds: io.BatchSampler(ds, shuffle=False, batch_size=4,
                                   drop_last=True),
    lambda io, ds: io.BatchSampler(
        sampler=io.RandomSampler(ds, replacement=True, num_samples=9),
        batch_size=2),
    lambda io, ds: io.BatchSampler(
        sampler=io.WeightedRandomSampler(np.arange(1, 24), 10),
        batch_size=3)],
    ids=["shuffle", "sequence_drop_last", "replacement", "weighted"])
def test_samplers_draw_the_reference_order(make):
    ds = list(range(23))
    out = {}
    for name, io in (("jax", jio), ("torch", tio)):
        np.random.seed(11)
        s = make(io, ds)
        out[name] = [list(s) for _ in range(3)]
        out[name + "_len"] = len(s)
    assert out["torch"] == out["jax"]
    assert out["torch_len"] == out["jax_len"]


def test_random_split_and_datasets_equal_reference():
    x, y = _data()
    splits = {}
    for name, io in (("jax", jio), ("torch", tio)):
        np.random.seed(5)
        parts = io.random_split(io.TensorDataset([x, y]), [0.5, 0.5])
        splits[name] = [p.indices for p in parts]
    got = splits["torch"]
    assert got == splits["jax"]
    assert sorted(got[0] + got[1]) == list(range(23))
    comp = tio.ComposeDataset([tio.TensorDataset([x]),
                               tio.TensorDataset([y])])
    assert len(comp) == 23 and len(comp[4]) == 2
    np.testing.assert_array_equal(comp[4][1], y[4])
    sub = tio.Subset(tio.TensorDataset([x, y]), [3, 1])
    np.testing.assert_array_equal(sub[1][0], x[1])

    class Stream(tio.IterableDataset):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def __iter__(self):
            return iter(range(self.lo, self.hi))

    chain = tio.ChainDataset([Stream(0, 3), Stream(3, 5)])
    assert [int(v) for v in chain] == [0, 1, 2, 3, 4]
    loader = tio.DataLoader(Stream(0, 7), batch_size=3)
    assert [b.tolist() for b in loader] == [[0, 1, 2], [3, 4, 5], [6]]


def test_collate_stacks_numpy_tensors_and_containers():
    s = [{"a": np.ones(2), "b": (torch.tensor([1, 2]), 3)},
         {"a": np.zeros(2), "b": (torch.tensor([3, 4]), 4)}]
    out = tio.default_collate_fn(s)
    np.testing.assert_array_equal(out["a"], [[1, 1], [0, 0]])
    assert isinstance(out["b"][0], torch.Tensor)
    assert out["b"][0].tolist() == [[1, 2], [3, 4]]
    np.testing.assert_array_equal(out["b"][1], [3, 4])


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_and_numpy_stream_equal_reference(shuffle, workers):
    """Over the global stream (``RandomSampler``) the port's loader draws
    what the reference's does, worker seeds included (one ``randint`` a
    worker start, before the epoch's permutation)."""
    x, y = _data()
    out = {}
    for name, io in (("jax", jio), ("torch", tio)):
        np.random.seed(3)
        loader = io.DataLoader(io.TensorDataset([x, y]), batch_size=4,
                               shuffle=shuffle, num_workers=workers)
        out[name] = [list(loader), list(loader)]        # two epochs
        out[name + "_next"] = np.random.randint(0, 2 ** 31)
    for a, b in zip(out["torch"], out["jax"]):
        _same_batches(a, b)
    assert out["torch_next"] == out["jax_next"]


def test_workers_yield_the_in_process_batches():
    """Under the epoch-seeded sampler (supervised fit's), 2 workers yield
    the batches of an in-process loader, epoch by epoch."""
    x, y = _data()
    ds = tio.TensorDataset([x, y])
    got = {}
    for workers in (0, 2):
        sampler = tio.DistributedBatchSampler(ds, 4, num_replicas=1,
                                              shuffle=True)
        loader = tio.DataLoader(ds, batch_sampler=sampler,
                                num_workers=workers)
        got[workers] = []
        for epoch in range(2):
            sampler.set_epoch(epoch)
            got[workers].append(list(loader))
    for a, b in zip(got[2], got[0]):
        _same_batches(a, b)


def test_workers_see_worker_info_and_tensor_samples():
    class Who(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            info = tio.get_worker_info()
            return torch.tensor([i, -1 if info is None else info.id])

    out = list(tio.DataLoader(Who(), batch_size=2, num_workers=2))
    assert all(isinstance(b, torch.Tensor) for b in out)
    got = torch.cat(out).tolist()
    assert [r[0] for r in got] == list(range(8))
    assert {r[1] for r in got} == {0, 1}
    assert tio.get_worker_info() is None


@pytest.mark.parametrize("workers", [0, 2])
def test_resume_iter_skips_exactly(workers):
    x, y = _data()
    ds = tio.TensorDataset([x, y])
    sampler = tio.DistributedBatchSampler(ds, 4, num_replicas=1,
                                          shuffle=True)
    sampler.set_epoch(2)
    loader = tio.DataLoader(ds, batch_sampler=sampler, num_workers=workers)
    full = list(loader)
    for skip in (0, 1, 4, 6, 9):
        _same_batches(list(loader.resume_iter(skip)), full[skip:])


def test_worker_error_surfaces():
    class Bad(tio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise ValueError("bad sample")
            return np.zeros(2)

    with pytest.raises(RuntimeError, match="bad sample"):
        list(tio.DataLoader(Bad(), batch_size=2, num_workers=2))


def test_save_load_cross_framework(tmp_path):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    ids = rng.integers(0, 9, (5,))
    # the port writes, both read
    t = {"w": torch.tensor(a), "h": torch.tensor(a).bfloat16(),
         "ids": torch.tensor(ids), "n": 3, "lst": [torch.tensor(a[0]), None]}
    tio.save(t, str(tmp_path / "port.pdparams"))
    with open(tmp_path / "port.pdparams", "rb") as f:
        raw = pickle.load(f)                       # numpy only on disk
    assert isinstance(raw["w"], np.ndarray) and raw["h"]["__bf16__"]
    j = jio.load(str(tmp_path / "port.pdparams"))
    np.testing.assert_array_equal(np.asarray(j["w"]), a)
    assert j["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(j["h"], np.float32),
                                  t["h"].float().numpy())
    back = tio.load(str(tmp_path / "port.pdparams"))
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"],
                                                             t["h"])
    assert torch.equal(back["ids"], t["ids"]) and back["n"] == 3
    assert torch.equal(back["lst"][0], t["lst"][0]) and back["lst"][1] is None
    # the reference writes, the port reads
    import paddle_tpu as pt
    jt = {"w": pt.to_tensor(a), "h": jnp.asarray(a, jnp.bfloat16),
          "step": 7}
    jio.save(jt, str(tmp_path / "jax.pdparams"))
    got = tio.load(str(tmp_path / "jax.pdparams"))
    assert isinstance(got["w"], torch.Tensor) and got["w"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["w"].numpy(), a)
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["h"].float().numpy(),
                                  np.asarray(jt["h"], np.float32))
    assert got["step"] == 7
    assert os.path.getsize(tmp_path / "jax.pdparams") > 0


def test_refusals_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 15"):
        tio.DataLoader([1, 2], use_native_ring=True)
    with pytest.raises(NotImplementedError, match="item 13"):
        tio.save_sharded({}, "x")
    with pytest.raises(NotImplementedError, match="item 13"):
        tio.load_sharded("x")

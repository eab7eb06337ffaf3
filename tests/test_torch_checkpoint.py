"""The port's durable checkpoints (``reliability.ckpt``,
``io.CheckpointManager``) against the JAX package's, on the CPU.

- the state flattens as ``jax.tree_util`` flattens it: the same leaves
  in the same order and the same integer skeleton;
- a checkpoint written by the port passes the reference's
  ``verify_checkpoint`` and reads there with equal leaves and meta (bf16
  exactly), and the reverse; no torch object is pickled;
- the durability behaviours of the reference's own tests (torn and
  corrupt files, injected write, rename and swap faults, newest-valid
  fallback, pruning, the async checkpointer's barrier and sticky
  failures, the manager's interval and retention) hold in both
  packages: each case runs once against each;
- the telemetry hooks and sharded checkpoints name their ROADMAP items.
"""
import collections
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.io.checkpoint as jio_ckpt
import paddle_tpu.reliability as jrel
import paddle_tpu.reliability.ckpt as jckpt
import paddle_tpu_torch.io.checkpoint as tio_ckpt
import paddle_tpu_torch.reliability as trel
import paddle_tpu_torch.reliability.ckpt as tckpt

IMPLS = {
    "jax": types.SimpleNamespace(ckpt=jckpt, rel=jrel,
                                 Manager=jio_ckpt.CheckpointManager),
    "torch": types.SimpleNamespace(ckpt=tckpt, rel=trel,
                                   Manager=tio_ckpt.CheckpointManager),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _state(v=0.0):
    return {"w": np.arange(6.0).reshape(2, 3) + v,
            "b": np.full(3, v, np.float32),
            "nest": {"step": int(v), "extra": [np.float64(v), None]}}


def _corrupt(path, name="leaf_00000.pkl"):
    with open(os.path.join(path, name), "ab") as f:
        f.write(b"\x00torn")


def _tree():
    rng = np.random.default_rng(0)
    return {"z": rng.standard_normal(3).astype(np.float32),
            "a": [np.int64(4), None, (1.5, rng.integers(0, 9, (2, 2)))],
            "m": collections.OrderedDict([("y", np.ones(2)),
                                          ("x", np.zeros(1))]),
            "k": {"c": 2, "b": {"q": np.float32(1.0)}}}


def test_flatten_matches_jax_tree_util():
    tree = _tree()
    leaves, skeleton = tckpt._flatten(tree)
    jleaves, treedef = jax.tree_util.tree_flatten(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a is b
    jskel = jax.tree_util.tree_unflatten(treedef, list(range(len(jleaves))))
    assert skeleton == jskel
    assert list(skeleton["m"]) == ["y", "x"]        # OrderedDict order
    back = tckpt._unflatten(skeleton, leaves)
    assert jax.tree_util.tree_structure(back) == treedef


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    p = str(tmp_path / "c")
    w = torch.linspace(-2, 2, 12).reshape(3, 4)
    state = {"params": {"w": w, "h": w.bfloat16()},
             "opt_state": {"m": {"w": torch.ones(3, 4)}}, "n": 3,
             "none": None}
    meta = {"step": 3, "rng_key": np.asarray([1, 2], np.uint32),
            "cursor": {"epoch": 1, "batch": 4}}
    tckpt.write_checkpoint(p, state, meta, step=3)
    for name in os.listdir(p):
        if name.endswith(".pkl"):
            with open(os.path.join(p, name), "rb") as f:
                assert "torch" not in repr(pickle.load(f))
    manifest = jckpt.verify_checkpoint(p)
    assert manifest["step"] == 3 and manifest["num_leaves"] == 4
    js, jm = jckpt.read_checkpoint(p)
    ts, tm = tckpt.read_checkpoint(p)
    np.testing.assert_array_equal(np.asarray(js["params"]["w"]), w.numpy())
    assert js["params"]["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(js["params"]["h"], np.float32),
                                  w.bfloat16().float().numpy())
    assert js["n"] == 3 and js["none"] is None
    assert torch.equal(ts["params"]["h"], w.bfloat16())
    assert torch.equal(ts["opt_state"]["m"]["w"], torch.ones(3, 4))
    assert jm["cursor"] == tm["cursor"] == {"epoch": 1, "batch": 4}
    np.testing.assert_array_equal(np.asarray(jm["rng_key"]), [1, 2])
    assert tm["rng_key"].tolist() == [1, 2]


def test_reference_checkpoint_reads_in_the_port(tmp_path):
    p = str(tmp_path / "c")
    w = jnp.linspace(-2, 2, 12).reshape(3, 4)
    state = {"params": {"w": w, "h": w.astype(jnp.bfloat16)},
             "opt_state": {"v": {"w": jnp.ones((3, 4))}}, "n": 2.5}
    meta = {"step_count": 7, "fit_rng": jax.random.PRNGKey(3)}
    jckpt.write_checkpoint(p, state, meta, step=7)
    tckpt.verify_checkpoint(p)
    ts, tm = tckpt.read_checkpoint(p)
    assert isinstance(ts["params"]["w"], torch.Tensor)
    np.testing.assert_array_equal(ts["params"]["w"].numpy(), np.asarray(w))
    assert ts["params"]["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ts["params"]["h"].float().numpy(),
                                  np.asarray(w.astype(jnp.bfloat16),
                                             np.float32))
    assert ts["n"] == 2.5 and tm["step_count"] == 7
    assert tm["fit_rng"].tolist() == np.asarray(
        jax.random.PRNGKey(3)).tolist()
    assert tckpt.checkpoint_meta(p)["step_count"] == 7


def test_roundtrip_preserves_structure_and_values(impl, tmp_path):
    p = str(tmp_path / "c")
    meta = {"step": 3, "cursor": {"epoch": 1, "index": 4}}
    manifest = impl.ckpt.write_checkpoint(p, _state(2.0), meta, step=3)
    assert manifest["step"] == 3
    assert any(k.startswith("leaf_") for k in manifest["files"])
    state, m2 = impl.ckpt.read_checkpoint(p)
    np.testing.assert_array_equal(np.asarray(state["w"]),
                                  np.arange(6.0).reshape(2, 3) + 2.0)
    np.testing.assert_array_equal(np.asarray(state["b"]), np.full(3, 2.0))
    assert state["nest"]["step"] == 2
    assert state["nest"]["extra"][1] is None
    assert m2["cursor"] == {"epoch": 1, "index": 4}


@pytest.mark.parametrize("victim", ["leaf_00000.pkl", "skeleton.pkl",
                                    "meta.pkl"])
def test_any_torn_file_is_detected(impl, tmp_path, victim):
    p = str(tmp_path / "c")
    impl.ckpt.write_checkpoint(p, _state())
    _corrupt(p, victim)
    with pytest.raises(impl.rel.CheckpointCorruptError, match=victim):
        impl.ckpt.read_checkpoint(p)
    with pytest.raises(impl.rel.CheckpointCorruptError):
        impl.ckpt.verify_checkpoint(p)


def test_missing_files_and_overwrite(impl, tmp_path):
    p = str(tmp_path / "c")
    impl.ckpt.write_checkpoint(p, _state(1.0))
    with pytest.raises(FileExistsError):
        impl.ckpt.write_checkpoint(p, _state(2.0))
    impl.ckpt.write_checkpoint(p, _state(2.0), overwrite=True)
    assert impl.ckpt.read_checkpoint(p)[0]["nest"]["step"] == 2
    os.remove(os.path.join(p, "leaf_00000.pkl"))
    with pytest.raises(impl.rel.CheckpointCorruptError,
                       match="missing file"):
        impl.ckpt.read_checkpoint(p)
    os.remove(os.path.join(p, impl.ckpt.MANIFEST_NAME))
    with pytest.raises(impl.rel.CheckpointCorruptError,
                       match="missing manifest"):
        impl.ckpt.read_checkpoint(p)


@pytest.mark.parametrize("point,visit", [("CKPT_WRITE", 1),
                                         ("CKPT_RENAME", 0)])
def test_injected_fault_leaves_no_visible_checkpoint(impl, tmp_path, point,
                                                     visit):
    p = str(tmp_path / "c")
    fi = impl.rel.FaultInjector(seed=0).on(getattr(impl.rel.faults, point),
                                           schedule=[visit])
    with pytest.raises(impl.rel.InjectedFault):
        impl.ckpt.write_checkpoint(p, _state(), injector=fi)
    assert not os.path.exists(p)
    tmps = [d for d in os.listdir(tmp_path) if ".tmp." in d]
    assert len(tmps) == 1 and os.listdir(os.path.join(tmp_path, tmps[0]))


def test_restore_falls_back_to_newest_valid(impl, tmp_path):
    store = impl.rel.CheckpointStore(str(tmp_path))
    for s in (1, 2, 3):
        store.save(s, _state(float(s)))
    _corrupt(store.step_path(3))
    state, meta, step = store.restore()
    assert step == 2 and state["nest"]["step"] == 2 and meta["step"] == 2
    assert store.skipped and store.skipped[0][0] == 3
    with pytest.raises(impl.rel.CheckpointCorruptError):
        store.restore(step=3)
    assert impl.rel.CheckpointStore(str(tmp_path / "e")).restore() == \
        (None, None, None)


def test_crashed_save_invisible_and_swept(impl, tmp_path):
    store = impl.rel.CheckpointStore(str(tmp_path))
    store.save(1, _state(1.0))
    store.injector = impl.rel.FaultInjector(seed=0).on(
        impl.rel.faults.CKPT_WRITE, schedule=[0])
    with pytest.raises(impl.rel.InjectedFault):
        store.save(2, _state(2.0))
    assert store.all_steps() == [1]
    assert any(".tmp." in d for d in os.listdir(store.directory))
    store.injector = None
    store.save(3, _state(3.0))
    assert not any(".tmp." in d for d in os.listdir(store.directory))
    assert store.restore()[2] == 3


def test_prune_counts_valid_only_and_keeps_newest_valid(impl, tmp_path):
    store = impl.rel.CheckpointStore(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        store.save(s, _state(float(s)))
    assert store.all_steps() == [2, 3]
    _corrupt(store.step_path(3))
    store2 = impl.rel.CheckpointStore(str(tmp_path), max_to_keep=2)
    store2.save(4, _state(4.0))
    assert store2.valid_steps() == [2, 4]
    assert store2.restore()[2] == 4


def test_kill_inside_overwrite_swap_recovers_old(impl, tmp_path):
    store = impl.rel.CheckpointStore(str(tmp_path))
    store.save(5, _state(1.0))
    store.injector = impl.rel.FaultInjector(seed=0).on(
        impl.rel.faults.CKPT_SWAP, schedule=[0])
    with pytest.raises(impl.rel.InjectedFault):
        store.save(5, _state(2.0))
    assert any(n.endswith(".old") for n in os.listdir(tmp_path))
    store2 = impl.rel.CheckpointStore(str(tmp_path))     # heals the swap
    state, _, step = store2.restore()
    assert step == 5 and state["nest"]["step"] == 1
    impl.ckpt.verify_checkpoint(store2.step_path(5))
    store2.save(6, _state(6.0))
    assert store2.valid_steps() == [5, 6]


def test_async_checkpointer_barrier_sticky_failure_and_snapshot(impl,
                                                                tmp_path):
    store = impl.rel.CheckpointStore(str(tmp_path / "a"))
    ac = impl.ckpt.AsyncCheckpointer(store)
    arr = np.arange(4.0)
    ac.save(1, {"w": arr})
    arr[:] = -1.0                          # the snapshot was taken
    for s in (2, 3):
        ac.save(s, _state(float(s)))
    ac.wait()
    assert store.valid_steps() == [1, 2, 3]
    np.testing.assert_array_equal(
        np.asarray(store.restore(step=1)[0]["w"]), np.arange(4.0))
    ac.close()
    bad = impl.rel.CheckpointStore(str(tmp_path / "b"))
    bad.injector = impl.rel.FaultInjector(seed=0).on(
        impl.rel.faults.CKPT_RENAME, schedule=[0])
    ac = impl.ckpt.AsyncCheckpointer(bad)
    ac.save(1, _state())
    with pytest.raises(impl.rel.InjectedFault):
        ac.wait()
    assert bad.all_steps() == []


def test_async_snapshot_copies_torch_tensors(tmp_path):
    store = trel.CheckpointStore(str(tmp_path))
    ac = tckpt.AsyncCheckpointer(store)
    w = torch.arange(4.0)
    ac.save(1, {"w": w})
    w.fill_(-1.0)
    ac.wait()
    assert store.restore()[0]["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_manager_interval_retention_and_metrics(impl, tmp_path):
    mgr = impl.Manager(str(tmp_path / "m"), max_to_keep=2,
                       save_interval_steps=5)
    for s in range(21):
        assert mgr.save(s, _state(float(s))) == (s % 5 == 0)
    assert mgr.all_steps() == [15, 20]
    _corrupt(mgr.store.step_path(20))
    assert mgr.restore()["nest"]["step"] == 15
    mgr.save(21, _state(21.0), force=True, metrics={"loss": 0.25})
    assert mgr.all_steps() == [15, 21]
    assert mgr.metrics(21) == {"loss": 0.25} and mgr.metrics(15) is None
    assert mgr.restore(step=99) is None
    amgr = impl.Manager(str(tmp_path / "a"), async_save=True)
    amgr.save(1, _state(1.0))
    amgr.save(2, _state(2.0))
    assert amgr.latest_step() == 2
    amgr.close()


def test_port_refusals_name_their_roadmap_items(tmp_path):
    with pytest.raises(NotImplementedError, match="item 8"):
        trel.CheckpointStore(str(tmp_path), registry=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        trel.FaultInjector(registry=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        trel.TrainSupervisor(str(tmp_path), registry=object())
    with pytest.raises(NotImplementedError, match="item 13"):
        tio_ckpt.save_sharded({}, str(tmp_path / "s"))

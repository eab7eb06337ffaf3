"""The port's ``paddle.static`` against the JAX package's, on the CPU.

Case by case from ``tests/test_static_inference.py``,
``tests/test_static_passes.py`` and ``tests/test_static_regressions.py``:
each script runs once through ``paddle_tpu`` and once through
``paddle_tpu_torch`` (both seeded alike, so their random initializers
draw the same weights) and every fetch, gradient and loss is held to the
reference's within 1e-5; static dropout masks bit for bit. The
reference's cases of other modules (``sparse``, ``geometric``) and the
``BatchScheduler`` / ``Predictor`` cases that need no Program are
elsewhere (``test_torch_batch_scheduler.py``, ``test_torch_export.py``).

- ``chip_smoke.static_stack`` (the card phase ``static_jit``'s program)
  at 2 blocks, hidden 64, 4 heads of 16: three ``AdamW.minimize`` runs,
  losses, the loss's and the gradient fetches within 1e-5 of the
  reference's, the port's losses bitwise its eager stack's; the
  ``save_inference_model`` archive EQUAL to the Executor's ``for_test``
  fetch; building the program calls no kernel wrapper on a tensor with
  values (shapes are inferred on the meta device).
- ``static.nn``'s layer functions in a program, against the reference's.
- The reference's traced-positional-argument fault (ROADMAP, Queue 3):
  where its Executor raises on a Python argument given by position, the
  port runs and equals the reference's eager result.
- The recorder costs the eager path nothing: outside ``program_guard``
  and ``enable_static`` no hook is installed and ``dispatch`` never asks
  one.
"""
import os.path as osp
import types

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jt
import paddle_tpu.static as jst
import paddle_tpu_torch as pt
import paddle_tpu_torch.static as tst
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import tensor as tcore
from paddle_tpu_torch.ops.registry import OPS as TOPS

TOL = dict(rtol=1e-5, atol=1e-5)
JAX = types.SimpleNamespace(pt=jt, st=jst, OPS=JOPS, port=False)
PORT = types.SimpleNamespace(pt=pt, st=tst, OPS=TOPS, port=True)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    place = tdevice._default[0]
    before = torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


def _np(v):
    return np.asarray(v, dtype=np.float64)


def _both(script, *args, **tol):
    """``script(side, *args)`` through both packages, seeded alike: the
    port's outputs within 1e-5 of the reference's (leaf by leaf)."""
    jt.seed(0)
    want = script(JAX, *args)
    pt.seed(0)
    got = script(PORT, *args)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=str(i),
                                   **(tol or TOL))
    return got, want


def _progs(m):
    return m.st.Program(), m.st.Program()


# ------------------------------------------------- test_static_inference


def _build_and_run(m):
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [4, 3], "float32")
        y = m.pt.add(m.pt.multiply(x, x), x)
        z = m.pt.mean(y)
    assert main.num_ops == 3 and x.shape == [4, 3]
    xv = np.random.default_rng(1).random((4, 3)).astype("float32")
    return m.st.Executor().run(main, feed={"x": xv}, fetch_list=[z])


def test_program_build_and_run():
    _both(_build_and_run)


def _tensor_methods(m):
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [2, 5], "float32")
        s = ((x + 1.0) * 2.0).sum()
    return m.st.Executor().run(main, feed={"x": np.ones((2, 5), np.float32)},
                               fetch_list=[s])


def test_tensor_methods_record():
    got, _ = _both(_tensor_methods)
    assert float(got[0]) == pytest.approx(40.0)


def test_executor_cache_reuse():
    def script(m):
        main, startup = _progs(m)
        with m.st.program_guard(main, startup):
            x = m.st.data("x", [2, 2], "float32")
            y = m.pt.exp(x)
        exe = m.st.Executor()
        out = exe.run(main, feed={"x": np.zeros((2, 2), np.float32)},
                      fetch_list=[y])
        sizes = [len(exe._cache)]
        out += exe.run(main, feed={"x": np.ones((2, 2), np.float32)},
                       fetch_list=[y])
        sizes.append(len(exe._cache))
        out += exe.run(main, feed={"x": np.ones((3, 2), np.float32)},
                       fetch_list=[y])
        sizes.append(len(exe._cache))
        return out + [np.asarray(sizes)]

    got, _ = _both(script)
    assert list(got[-1]) == [1, 1, 2]


def _fc_train(m):
    main, startup = _progs(m)
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 4).astype("float32")
    ys = xs @ rng.rand(4, 1).astype("float32")
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [16, 4], "float32")
        label = m.st.data("label", [16, 1], "float32")
        pred = m.st.nn.fc(x, 1)
        loss = m.pt.mean(m.pt.square(pred - label))
        m.pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = m.st.Executor()
    exe.run(startup)
    return [np.asarray([float(exe.run(main, feed={"x": xs, "label": ys},
                                      fetch_list=[loss])[0])
                        for _ in range(50)])]


def test_static_nn_fc_train_minimize():
    got, _ = _both(_fc_train)
    assert got[0][-1] < got[0][0] * 0.05


def test_optimizer_state_lives_with_its_program():
    """The Executor keeps a program's optimizer state while the program
    lives, and drops it with the program, ``close()`` or not: a new
    Program never takes up another's state."""
    import gc
    main, startup = _progs(PORT)
    with tst.program_guard(main, startup):
        x = tst.data("x", [2, 3], "float32")
        w = tst.create_parameter([3, 1], "float32")
        loss = pt.mean(pt.matmul(x, w))
        pt.optimizer.Adam(learning_rate=0.1).minimize(loss)
    exe = tst.Executor()
    exe.run(startup)
    for _ in range(2):
        exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[loss])
    assert [s[1] for s in exe._opt_states.values()] == [2]
    exe.close()
    assert len(exe._opt_states) == 1
    del main, loss, x, w
    gc.collect()
    assert len(exe._opt_states) == 0


def test_cuda_places_lists_the_cards():
    """``cuda_places`` names one place per card; each resolves to a
    CUDA device (the reference's TPU build lists none)."""
    assert tst.cuda_places([0, 2]) == ["gpu:0", "gpu:2"]
    assert tst.cuda_places() == [f"gpu:{i}"
                                 for i in range(torch.cuda.device_count())]
    assert jst.cuda_places() == []
    if torch.cuda.is_available():
        assert tdevice.place_to_device(tst.cuda_places()[0]) == \
            torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdevice.place_to_device(tst.cuda_places([0])[0])


def _append_backward(m):
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [3, 2], "float32")
        w = m.st.create_parameter([2, 2], "float32")
        loss = m.pt.sum(m.pt.matmul(x, w))
        grads = m.st.append_backward(loss)
    exe = m.st.Executor()
    exe.run(startup)
    xv = np.random.default_rng(2).random((3, 2)).astype("float32")
    return exe.run(main, feed={"x": xv}, fetch_list=[grads[0][1].name]) \
        + [xv.T @ np.ones((3, 2))]


def test_append_backward_grad_fetch():
    got, _ = _both(_append_backward)
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5)


def _eager_layer(m):
    main, startup = _progs(m)
    layer = m.pt.nn.Linear(6, 3)
    if m.port:
        layer = layer.to("cpu")
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [2, 6], "float32")
        loss = m.pt.mean(layer(x))
        m.pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    assert len(main._param_names) == 2
    before = np.asarray(layer.weight.numpy()).copy()
    out = m.st.Executor().run(main, feed={"x": np.ones((2, 6), np.float32)},
                              fetch_list=[loss])
    after = np.asarray(layer.weight.numpy())
    assert not np.allclose(before, after)   # the eager parameter moved
    return out + [before, after]


def test_eager_layer_under_program_guard():
    _both(_eager_layer)


def test_program_clone_for_test():
    for m in (JAX, PORT):
        main, startup = _progs(m)
        with m.st.program_guard(main, startup):
            x = m.st.data("x", [2, 2], "float32")
            loss = m.pt.mean(m.pt.nn.functional.relu(x))
            m.pt.optimizer.SGD(0.1).minimize(loss)
        test_prog = main.clone(for_test=True)
        assert test_prog._train_spec is None and not test_prog._grad_requests
        assert main._train_spec is not None
        assert test_prog.num_ops == main.num_ops


def _gradients(m):
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [4], "float32")
        (gx,) = m.st.gradients(m.pt.sum(m.pt.square(x)), x)
    return m.st.Executor().run(
        main, feed={"x": np.arange(4, dtype=np.float32)}, fetch_list=[gx])


def test_gradients_api():
    got, _ = _both(_gradients)
    np.testing.assert_allclose(got[0], 2 * np.arange(4), rtol=1e-6)


def _inference_archive(m, tmp, knobs=False):
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [1, 4], "float32")
        out = m.st.nn.fc(x, 2, activation="relu")
    exe = m.st.Executor()
    exe.run(startup)
    prefix = str(tmp / ("port" if m.port else "jax") / "infer")
    m.st.save_inference_model(prefix, [x], [out], exe)
    xv = np.random.default_rng(3).random((1, 4)).astype("float32")
    (fetched,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    prog, feeds, fetches = m.st.load_inference_model(prefix, exe)
    assert feeds == ["x"] and len(fetches) == 1
    (direct,) = prog(xv)
    inf = m.pt.inference

    def config():
        cfg = inf.Config(prefix)
        if m.port:
            cfg.disable_gpu()
        return cfg

    pred = inf.create_predictor(config())
    assert pred.get_input_names() == ["x"]
    pred.get_input_handle("x").copy_from_cpu(xv)
    pred.run()
    via = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    res = [fetched, np.asarray(direct), via]
    if knobs:
        cfg = config()
        cfg.enable_memory_optim()
        cfg.enable_profile()
        res.append(inf.create_predictor(cfg).run([xv.copy()])[0])
        assert cfg.profile_stats()["runs"] == 1
        assert cfg.profile_stats()["total_ms"] > 0
        assert cfg.summary()["memory_optim"] is True
        with pytest.raises(NotImplementedError):
            config().switch_ir_optim(False)
        config().switch_ir_optim(True)
    return res


def test_save_load_inference_model_predictor(tmp_path):
    got, _ = _both(_inference_archive, tmp_path)
    np.testing.assert_array_equal(got[0], got[1])     # archive = Executor
    np.testing.assert_array_equal(got[1], got[2])
    assert (got[2] >= 0).all()


def test_predictor_config_knobs_functional(tmp_path):
    got, _ = _both(_inference_archive, tmp_path, True)
    np.testing.assert_array_equal(got[3], got[2])


def _opt_state(m):
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [8, 4], "float32")
        w = m.st.create_parameter([4, 1], "float32")
        loss = m.pt.mean(m.pt.square(m.pt.matmul(x, w)))
        m.pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = m.st.Executor()
    exe.run(startup)
    xv = np.random.default_rng(4).random((8, 4)).astype("float32")
    # the port keys the state by the Program (weakly), the reference by id
    key = main if m.port else id(main)
    out = exe.run(main, feed={"x": xv}, fetch_list=[loss])
    st0 = exe._opt_states[key][1]
    out += exe.run(main, feed={"x": xv}, fetch_list=[loss, "x"])
    assert exe._opt_states[key][1] == st0 + 1     # state continued
    out += exe.run(main, feed={"x": xv[:5]}, fetch_list=[loss])
    assert exe._opt_states[key][1] == st0 + 2
    return out


def test_opt_state_survives_fetch_and_shape_change():
    _both(_opt_state)


def _freeze(m):
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [4, 2], "float32")
        w = m.st.create_parameter([2, 2], "float32", name="w_train")
        b = m.st.create_parameter([2], "float32", name="b_frozen",
                                  is_bias=True)
        loss = m.pt.mean(m.pt.square(m.pt.matmul(x, w) + b + 1.0))
        m.pt.optimizer.SGD(0.1).minimize(loss, parameter_list=["w_train"])
    exe = m.st.Executor()
    exe.run(startup)
    scope = m.st.global_scope()._vars
    b0, w0 = np.asarray(scope["b_frozen"]).copy(), \
        np.asarray(scope["w_train"]).copy()
    exe.run(main, feed={"x": np.ones((4, 2), np.float32)}, fetch_list=[loss])
    np.testing.assert_array_equal(np.asarray(scope["b_frozen"]), b0)
    assert not np.allclose(np.asarray(scope["w_train"]), w0)
    return [np.asarray(scope["w_train"])]


def test_minimize_parameter_list_freezes_others():
    _both(_freeze)


def _save_load_params(m, tmp):
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        m.st.nn.fc(m.st.data("x", [2, 3], "float32"), 2)
    exe = m.st.Executor()
    exe.run(startup)
    scope = m.st.global_scope()._vars
    pname = main._param_names[0]
    orig = np.asarray(scope[pname]).copy()
    prefix = str(tmp / ("port" if m.port else "jax") / "ckpt")
    m.st.save(main, prefix)
    scope[pname] = np.zeros_like(orig)
    m.st.load(main, prefix)
    np.testing.assert_array_equal(np.asarray(scope[pname]), orig)
    return [orig]


def test_static_save_load_params(tmp_path):
    _both(_save_load_params, tmp_path)


def _serialize(m, tmp):
    """The serialization surface: a program's description, the scope's
    persistables through a file, ``set_program_state`` and
    ``load_program_state``."""
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [2, 3], "float32")
        out = m.st.nn.fc(x, 2)
    exe = m.st.Executor()
    exe.run(startup)
    xv = np.random.default_rng(9).random((2, 3)).astype("float32")
    (before,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    desc = m.st.deserialize_program(
        m.st.serialize_program([x], [out], program=main))
    assert desc["feeds"] == ["x"] and desc["fetches"] == [out.name]
    assert [d[0] for d in desc["desc"]] == [op.op_type for op in
                                            main.global_block.ops]
    path = str(tmp / ("port" if m.port else "jax") / "p.bin")
    (tmp / ("port" if m.port else "jax")).mkdir(exist_ok=True)
    m.st.save_to_file(path, m.st.serialize_persistables([x], [out], exe,
                                                        program=main))
    w, b = main._param_names
    m.st.set_program_state(main, {w: np.zeros((3, 2), np.float32)})
    (zeroed,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    m.st.deserialize_persistables(main, m.st.load_from_file(path), exe)
    (restored,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    prefix = str(tmp / ("port" if m.port else "jax") / "state")
    m.st.save(main, prefix)
    state = m.st.load_program_state(prefix)
    assert {w, b} <= set(state)
    return [before, zeroed, restored, np.asarray(state[w])]


def test_program_serialization_and_state(tmp_path):
    got, _ = _both(_serialize, tmp_path)
    np.testing.assert_array_equal(got[2], got[0])


def _shells(m):
    """``CompiledProgram``, ``ParallelExecutor``, the places and the EMA of
    a layer's weight."""
    main, startup = _progs(m)
    with m.st.program_guard(main, startup):
        x = m.st.data("x", [2, 3], "float32")
        y = m.pt.exp(x) * 2.0
    xv = np.random.default_rng(10).random((2, 3)).astype("float32")
    (a,) = m.st.Executor().run(m.st.CompiledProgram(main), feed={"x": xv},
                               fetch_list=[y])
    (b,) = m.st.ParallelExecutor(main_program=main).run(
        fetch_list=[y], feed={"x": xv})
    assert m.st.cpu_places(2) == ["cpu:0", "cpu:1"]
    m.pt.seed(11)
    lin = m.pt.nn.Linear(3, 2)
    lin = lin.to("cpu") if m.port else lin
    w0 = np.asarray(lin.weight.numpy()).copy()
    ema = m.st.ExponentialMovingAverage(0.5)
    ema.update([lin.weight])
    lin.weight.set_value(w0 * 2.0)
    ema.update([lin.weight])
    with ema.apply():
        inside = np.asarray(lin.weight.numpy()).copy()
    after = np.asarray(lin.weight.numpy())
    return [a, b, w0, inside, after]


def test_program_shells_and_the_ema():
    got, _ = _both(_shells)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[3], got[2] * 1.5, rtol=1e-6)
    np.testing.assert_array_equal(got[4], got[2] * 2.0)


# ---------------------------------------------------- test_static_passes


def _pass_program(m):
    main = m.st.Program()
    with m.st.program_guard(main):
        x = m.st.data("x", [2, 3])
        a = x * 2.0
        b = x * 2.0          # a CSE duplicate
        _dead = x + 100.0    # dead once the fetches are declared
        y = (a + b) * 1.0
    return main, x, y


def _cse_dce(m):
    main, x, y = _pass_program(m)
    m.st.normalize_program(main, [x], [y])
    n0 = len(main.global_block.ops)
    m.st.apply_pass(main, ["common_subexpression_elimination",
                           "dead_code_elimination"])
    assert len(main.global_block.ops) < n0
    return m.st.Executor().run(
        main, feed={"x": np.ones((2, 3), "float32")}, fetch_list=[y]) \
        + [np.asarray([n0, len(main.global_block.ops)])]


def test_cse_and_dce_shrink_and_preserve_semantics():
    got, _ = _both(_cse_dce)
    np.testing.assert_allclose(got[0], 4.0)


def test_dce_conservative_without_declared_fetches():
    for m in (JAX, PORT):
        main = m.st.Program()
        with m.st.program_guard(main):
            x = m.st.data("x", [2])
            _t1, _t2 = x * 1.0, x * 5.0
        n0 = len(main.global_block.ops)
        m.st.apply_pass(main, "dead_code_elimination")
        assert len(main.global_block.ops) == n0


def _build_strategy(m):
    bs = m.st.BuildStrategy()
    bs.memory_optimize = True
    bs.fuse_elewise_add_act_ops = True
    main = m.st.Program()
    with m.st.program_guard(main):
        x = m.st.data("x", [2])
        h = m.pt.nn.functional.relu(x + 1.0)
    m.st.normalize_program(main, [x], [h])
    m.st.apply_build_strategy(main, None, bs)
    relu_op = [op for op in main.global_block.ops
               if op.op_type == "relu"][0]
    assert relu_op.attrs.get("_fused_with_add")
    return m.st.Executor().run(
        main, feed={"x": np.array([-2.0, 2.0], "float32")}, fetch_list=[h])


def test_build_strategy_runs_and_tags_fusion():
    got, _ = _both(_build_strategy)
    np.testing.assert_allclose(got[0], [0.0, 3.0])


def test_unknown_pass_raises():
    for m in (JAX, PORT):
        main, _x, _y = _pass_program(m)
        with pytest.raises(ValueError):
            m.st.apply_pass(main, "nonexistent_pass")


def _cse_lists(m):
    main = m.st.Program()
    with m.st.program_guard(main):
        x = m.st.data("x", [2, 3, 4])
        y = m.pt.sum(x, axis=[0, 1]) + m.pt.sum(x, axis=[0, 1])
    m.st.normalize_program(main, [x], [y])
    m.st.apply_pass(main, "common_subexpression_elimination")
    return m.st.Executor().run(
        main, feed={"x": np.ones((2, 3, 4), "float32")}, fetch_list=[y])


def test_cse_with_list_valued_attrs():
    got, _ = _both(_cse_lists)
    np.testing.assert_allclose(got[0], 12.0)


def _dce_grads(m):
    main = m.st.Program()
    with m.st.program_guard(main):
        x = m.st.data("x", [3])
        grads = m.st.gradients([(x * x).sum()], [x])
    m.st.normalize_program(main, [x], grads)
    m.st.apply_pass(main, "dead_code_elimination")
    return m.st.Executor().run(
        main, feed={"x": np.array([1., 2., 3.], "float32")},
        fetch_list=grads)


def test_dce_keeps_grad_targets():
    got, _ = _both(_dce_grads)
    np.testing.assert_allclose(got[0], [2, 4, 6])


def _literalize(m, main, xname, value):
    """VarRef inputs named ``xname`` become the literal ``value``: a
    program whose producer was already folded to a constant."""
    ref = m.st.VarRef
    for op in main.global_block.ops:
        op.inputs = [value if isinstance(i, ref) and i.name == xname else i
                     for i in op.inputs]


def _fold_roots(m):
    main = m.st.Program()
    with m.st.program_guard(main):
        x = m.st.data("x", [2])
        f = m.st.data("f", [2])
        c = x * 3.0
        y = f + c
    m.st.normalize_program(main, [f], [c, y])
    _literalize(m, main, x.name, np.array([1.0, 1.0], "float32"))
    m.st.apply_pass(main, "constant_folding")
    return m.st.Executor().run(
        main, feed={"f": np.array([1.0, 2.0], "float32")}, fetch_list=[c, y])


def test_constant_folding_keeps_fetch_roots():
    got, _ = _both(_fold_roots)
    np.testing.assert_allclose(got[0], [3.0, 3.0])
    np.testing.assert_allclose(got[1], [4.0, 5.0])


def test_constant_folding_skips_stateful_ops():
    for m in (JAX, PORT):
        main = m.st.Program()
        with m.st.program_guard(main):
            x = m.st.data("x", [4])
            f = m.st.data("f", [4])
            r = m.pt.nn.functional.dropout(x * 1.0, p=0.5, training=True)
            y = f + r
        m.st.normalize_program(main, [f], [y])
        _literalize(m, main, x.name, np.ones(4, "float32"))
        m.st.apply_pass(main, "constant_folding")
        assert any("dropout" in op.op_type.lower()
                   for op in main.global_block.ops)


def _dropout_runs(m):
    main = m.st.Program()
    with m.st.program_guard(main):
        x = m.st.data("x", [32])
        y = m.pt.nn.functional.dropout(x, p=0.5, training=True)
    m.st.normalize_program(main, [x], [y])
    ex = m.st.Executor()
    feed = {"x": np.ones(32, "float32")}
    draws = [ex.run(main, feed=feed, fetch_list=[y])[0] for _ in range(6)]
    assert len({tuple(np.asarray(d).tolist()) for d in draws}) > 1
    main.random_seed = 1234
    main._version += 1
    a = ex.run(main, feed=feed, fetch_list=[y])[0]
    b = ex.run(main, feed=feed, fetch_list=[y])[0]
    np.testing.assert_array_equal(a, b)
    return draws + [a]


def test_static_dropout_resamples_per_run():
    """Fresh masks every run, pinned by ``random_seed``; bit for bit the
    reference's, run by run (R2's plain version)."""
    got, want = _both(_dropout_runs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _fold_wrt(m):
    main = m.st.Program()
    with m.st.program_guard(main):
        x = m.st.data("x", [2])
        f = m.st.data("f", [2])
        c = x * 3.0
        grads = m.st.gradients([f + c], [c])
    m.st.normalize_program(main, [f], grads)
    _literalize(m, main, x.name, np.array([1.0, 1.0], "float32"))
    m.st.apply_pass(main, "constant_folding")
    return m.st.Executor().run(
        main, feed={"f": np.array([1.0, 2.0], "float32")}, fetch_list=grads)


def test_constant_folding_keeps_grad_wrt_leaves():
    got, _ = _both(_fold_wrt)
    np.testing.assert_allclose(got[0], [1.0, 1.0])


def _fold_chain(m):
    main = m.st.Program()
    with m.st.program_guard(main):
        x = m.st.data("x", [2])
        c = x * 3.0
        grads = m.st.gradients([c * 2.0], [c])
    m.st.normalize_program(main, [], grads)
    _literalize(m, main, x.name, np.array([1.0, 1.0], "float32"))
    m.st.apply_pass(main, "constant_folding")
    return m.st.Executor().run(main, feed={}, fetch_list=grads)


def test_constant_folding_keeps_grad_chain_through_wrt():
    got, _ = _both(_fold_chain)
    np.testing.assert_allclose(got[0], [2.0, 2.0])


# ----------------------------------------------- test_static_regressions


def _unused_persistable(m):
    main, sp = _progs(m)
    with m.st.program_guard(main, sp):
        x = m.st.data("x", [2, 3])
        w = m.st.create_parameter([3, 2], name="w_used_reg")
        m.st.create_parameter([2, 2], name="w_unused_reg")
        y = m.OPS["matmul"](x, w)
    exe = m.st.Executor()
    exe.run(sp)
    return exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                   fetch_list=[y])


def test_unused_persistable_var_does_not_crash():
    got, _ = _both(_unused_persistable)
    assert got[0].shape == (2, 2)


def _wrt_intermediate(m):
    prog, sprog = _progs(m)
    with m.st.program_guard(prog, sprog):
        x = m.st.data("x2", [4])
        y = m.OPS["square"](x)
        (gy,) = m.st.gradients(m.OPS["sum"](y), y)
    exe = m.st.Executor()
    exe.run(sprog)
    return exe.run(prog, feed={"x2": np.arange(4, dtype=np.float32)},
                   fetch_list=[gy])


def test_gradients_wrt_intermediate():
    got, _ = _both(_wrt_intermediate)
    np.testing.assert_allclose(got[0], np.ones(4))


def _minimize_outside(m):
    prog, sprog = _progs(m)
    with m.st.program_guard(prog, sprog):
        x = m.st.data("x3", [2, 3])
        w = m.st.create_parameter([3, 1], name="w3_min_reg")
        loss = m.OPS["mean"](m.OPS["matmul"](x, w))
    m.pt.optimizer.SGD(learning_rate=0.1).minimize(loss)   # after the guard
    assert prog._train_spec is not None
    exe = m.st.Executor()
    exe.run(sprog)
    scope = m.st.global_scope()._vars
    before = np.asarray(scope["w3_min_reg"]).copy()
    exe.run(prog, feed={"x3": np.ones((2, 3), np.float32)},
            fetch_list=[loss])
    after = np.asarray(scope["w3_min_reg"])
    assert not np.allclose(before, after)
    return [after]


def test_minimize_outside_program_guard():
    _both(_minimize_outside)


def _dynamic_batch(m, tmp):
    prog, sprog = _progs(m)
    with m.st.program_guard(prog, sprog):
        x = m.st.data("x4", [-1, 4])
        w = m.st.create_parameter([4, 2], name="w4_exp_reg")
        y = m.OPS["matmul"](x, w)
    exe = m.st.Executor()
    exe.run(sprog)
    d = str(tmp / ("port" if m.port else "jax"))
    m.st.save_inference_model(osp.join(d, "m"), [x], [y], exe, program=prog)
    cfg = m.pt.inference.Config(osp.join(d, "m") + ".pdmodel",
                                osp.join(d, "m") + ".pdmeta")
    if m.port:
        cfg.disable_gpu()
    pred = m.pt.inference.create_predictor(cfg)
    outs = []
    for bs in (8, 3):
        xv = np.random.default_rng(bs).random((bs, 4)).astype(np.float32)
        pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(xv)
        pred.run()
        oh = pred.get_output_handle(pred.get_output_names()[0])
        outs.append(oh.copy_to_cpu())
        assert outs[-1].shape == (bs, 2)
    return outs


def test_dynamic_batch_export(tmp_path):
    _both(_dynamic_batch, tmp_path)


def test_name_scope_no_collision():
    for m in (JAX, PORT):
        pa, sa = _progs(m)
        with m.st.program_guard(pa, sa):
            with m.st.name_scope("blk"):
                m.st.nn.fc(m.st.data("xa", [1, 2]), 2)
        pb, sb = _progs(m)
        with m.st.program_guard(pb, sb):
            with m.st.name_scope("blk"):
                m.st.nn.fc(m.st.data("xb", [1, 2]), 2)
        assert not (set(pa._param_names) & set(pb._param_names))


def _global_mode(m):
    main = m.st.Program()
    m.pt.enable_static()
    try:
        assert not m.pt.in_dynamic_mode()
        with m.st.program_guard(main):
            x = m.st.data("x", [2, 3])
            y = x * 2.0 + 1.0
        xin = np.arange(6, dtype=np.float32).reshape(2, 3)
        (out,) = m.st.Executor().run(main, feed={"x": xin}, fetch_list=[y])
        np.testing.assert_allclose(out, xin * 2 + 1, rtol=1e-6)
    finally:
        m.pt.disable_static()
    assert m.pt.in_dynamic_mode()
    t = m.pt.to_tensor([1.0]) * 3       # the eager path is back
    return [out, t.numpy()]


def test_enable_static_global_mode():
    _both(_global_mode)


# ------------------------------------------------- the static_jit stack


def _stack(m, steps=3):
    """chip_smoke.static_stack at 2 blocks, hidden 64, 4 heads of 16,
    f32: the losses of ``steps`` minimize runs and the ``for_test``
    fetch after them, and the feed."""
    B, S, H, heads, inter, L = 2, 16, 64, 4, 96, 2
    xn = np.random.default_rng(5).standard_normal((B, S, H)).astype(
        np.float32)
    init = chip_smoke.stack_init(np, H, inter, L, seed=0)
    main, startup, _x, loss, _g = chip_smoke.static_stack(
        m.pt, B, S, H, heads, inter, L, "float32", init)
    exe = m.st.Executor()
    exe.run(startup)
    losses = [exe.run(main, feed={"x": xn}, fetch_list=[loss])[0]
              for _ in range(steps)]
    test = main.clone(for_test=True)
    (after,) = exe.run(test, feed={"x": xn}, fetch_list=[loss])
    return losses + [after], xn


def test_the_static_stack_trains_as_the_references():
    jt.seed(0)
    want, _ = _stack(JAX)
    pt.seed(0)
    got, xn = _stack(PORT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    assert got[2] < got[0]                           # the loss falls
    # the port's static losses are its eager stack's, bit for bit
    init = chip_smoke.stack_init(np, 64, 96, 2, seed=0)
    eager = chip_smoke.eager_stack(pt, torch, init, xn, 4, 3,
                                   device="cpu")
    assert [float(v) for v in eager] == [float(v) for v in got[:3]]


def test_the_static_stacks_gradients_and_archive(tmp_path):
    """append_backward's fetches within 1e-5 of the reference's; the
    ``for_test`` archive equal to the Executor's fetch."""
    def grads(m):
        B, S, H, heads, inter, L = 2, 16, 64, 4, 96, 2
        xn = np.random.default_rng(6).standard_normal((B, S, H)).astype(
            np.float32)
        init = chip_smoke.stack_init(np, H, inter, L, seed=1)
        main, startup, x, loss, pg = chip_smoke.static_stack(
            m.pt, B, S, H, heads, inter, L, "float32", init, train=False)
        exe = m.st.Executor()
        exe.run(startup)
        names = [g.name for _p, g in pg]
        outs = exe.run(main, feed={"x": xn}, fetch_list=[loss] + names)
        test = main.clone(for_test=True)
        (fetched,) = exe.run(test, feed={"x": xn}, fetch_list=[loss])
        if m.port:
            prefix = str(tmp_path / "stack")
            m.st.save_inference_model(prefix, [x], [loss], exe, program=test)
            prog, _f, _o = m.st.load_inference_model(prefix, exe)
            (arch,) = prog(xn)
            assert torch.equal(arch, torch.as_tensor(fetched))
        return outs

    _both(grads)


def test_building_a_program_runs_no_kernel_on_values(monkeypatch):
    """Shape inference runs the kernel wrappers on meta tensors only:
    building launches nothing and computes no plain version."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    seen = []

    def spy(fn):
        def inner(x, *a, **k):
            seen.append(x.device.type)
            return fn(x, *a, **k)
        return inner

    monkeypatch.setattr(fa, "flash_fwd", spy(fa.flash_fwd))
    monkeypatch.setattr(rn, "rms_norm_fwd", spy(rn.rms_norm_fwd))
    init = chip_smoke.stack_init(np, 64, 96, 2, seed=0)
    chip_smoke.static_stack(pt, 2, 16, 64, 4, 96, 2, "float32", init)
    assert seen and set(seen) == {"meta"}, seen


# ------------------------------------------ the reference's traced-argument fault

def _fault_cases():
    """name -> (build(m, x) -> output Variable, eager(m, x, scope) ->
    the same computation eagerly through ``m``)."""
    F = "nn.functional"

    def fn(m, name):
        out = m.pt
        for part in name.split("."):
            out = getattr(out, part)
        return out

    def mha(m):
        m.pt.seed(1)
        layer = m.pt.nn.MultiHeadAttention(6, 2)
        return layer.to("cpu") if m.port else layer

    def ln_eager(m, x, w):
        # by position: the reference's dispatch leaves a Tensor given by
        # keyword wrapped (its static.nn.layer_norm fails on that)
        return fn(m, F).layer_norm(x, [6], w["w"], w["b"])

    return {
        "reshape_list": (lambda m, x: m.pt.reshape(x, [4, 6]),
                         lambda m, x, w: m.pt.reshape(x, shape=[4, 6])),
        "method_reshape": (lambda m, x: x.reshape([6, 4]),
                           lambda m, x, w: m.pt.reshape(x, shape=[6, 4])),
        "reshape_tuple": (lambda m, x: m.pt.reshape(x, (2, 12)),
                          lambda m, x, w: m.pt.reshape(x, shape=[2, 12])),
        "unsqueeze": (lambda m, x: m.pt.unsqueeze(x, 0),
                      lambda m, x, w: m.pt.unsqueeze(x, axis=0)),
        "split": (lambda m, x: m.pt.split(x, 2, axis=-1)[1],
                  lambda m, x, w: m.pt.split(x, num_or_sections=2,
                                             axis=-1)[1]),
        "multi_head_attention": (
            lambda m, x: mha(m)(*[m.pt.reshape(x, shape=[1, 4, 6])] * 3),
            lambda m, x, w: mha(m)(*[m.pt.reshape(x, shape=[1, 4, 6])] * 3)),
        "static_nn_prelu": (
            lambda m, x: m.st.nn.prelu(m.pt.reshape(x, shape=[1, 4, 2, 3]),
                                       "all"),
            lambda m, x, w: m.pt.nn.PReLU()(m.pt.reshape(
                x, shape=[1, 4, 2, 3]))),
        "static_nn_group_norm": (
            lambda m, x: m.st.nn.group_norm(
                m.pt.reshape(x, shape=[1, 4, 2, 3]), 2),
            lambda m, x, w: m.pt.nn.GroupNorm(2, 4)(m.pt.reshape(
                x, shape=[1, 4, 2, 3]))),
        "static_nn_fc_3d": (
            lambda m, x: m.st.nn.fc(m.pt.reshape(x, shape=[2, 2, 6]), 3,
                                    activation="tanh"),
            lambda m, x, w: m.pt.tanh(fn(m, F).linear(
                m.pt.reshape(x, shape=[2, 12]), w["w"], w["b"]))),
        "static_nn_layer_norm": (
            lambda m, x: m.st.nn.layer_norm(
                m.pt.reshape(x, shape=[4, 6]), begin_norm_axis=1),
            lambda m, x, w: ln_eager(m, m.pt.reshape(x, shape=[4, 6]), w)),
    }


@pytest.mark.parametrize("case", sorted(_fault_cases()))
def test_positional_arguments_the_reference_traces(case):
    """The reference traces a Python argument given by position (in
    ``eval_shape`` while recording, or in its Executor's ``jax.jit``) and
    raises; the port keeps it a Python value and gives the reference's
    eager result."""
    build, eager = _fault_cases()[case]
    xn = np.random.default_rng(7).standard_normal((4, 6)).astype(np.float32)

    def run(m):
        m.pt.seed(0)
        main, startup = _progs(m)
        with m.st.program_guard(main, startup):
            x = m.st.data("x", [4, 6], "float32")
            out = build(m, x)
        exe = m.st.Executor()
        exe.run(startup)
        params = [np.asarray(m.st.global_scope()._vars[n])
                  for n in main._param_names]
        return exe, main, out, params

    with pytest.raises(Exception):      # at build (eval_shape) or run
        exe, main, out, _ = run(JAX)
        exe.run(main, feed={"x": xn}, fetch_list=[out])
    exe, main, out, params = run(PORT)
    (got,) = exe.run(main, feed={"x": xn}, fetch_list=[out])
    w = dict(zip(("w", "b"), (jt.to_tensor(p) for p in params)))
    want = eager(JAX, jt.to_tensor(xn), w)
    np.testing.assert_allclose(got, np.asarray(want.numpy()), **TOL)


# ------------------------------------------------------------ static.nn

_IMG = ([2, 4, 5, 5], "float32")
_SEQ = ([2, 6, 4], "float32")
STATIC_NN = {
    "embedding": (lambda m, x: m.st.nn.embedding(x, [10, 4]),
                  ([2, 3], "int32")),
    "conv2d": (lambda m, x: m.st.nn.conv2d(x, 3, 2), _IMG),
    "batch_norm": (lambda m, x: m.st.nn.batch_norm(x), _IMG),
    "dropout_is_test": (lambda m, x: m.st.nn.dropout(x, 0.3, is_test=True),
                        _IMG),
    "sequence_pool_max": (lambda m, x: m.st.nn.sequence_pool(x, "max"),
                          _SEQ),
    "sequence_softmax": (lambda m, x: m.st.nn.sequence_softmax(x), _SEQ),
    "data_norm": (lambda m, x: m.st.nn.data_norm(x), _SEQ),
    "sequence_first_step": (lambda m, x: m.st.nn.sequence_first_step(x),
                            _SEQ),
    "sequence_reverse": (lambda m, x: m.st.nn.sequence_reverse(x), _SEQ),
    "row_conv": (lambda m, x: m.st.nn.row_conv(x, 2), _SEQ),
    "bilinear_tensor_product": (
        lambda m, x: m.st.nn.bilinear_tensor_product(x, x, 3),
        ([4, 6], "float32")),
    "accuracy": (lambda m, x: m.st.accuracy(x, m.pt.argmax(x, axis=-1)),
                 ([4, 6], "float32")),
}


@pytest.mark.parametrize("case", sorted(STATIC_NN))
def test_static_nn_functions(case):
    """A ``static.nn`` layer function (and ``static.accuracy``) in a
    program: its parameters from the startup program under one seed, its
    fetch within 1e-5 of the reference's."""
    build, (shape, dt) = STATIC_NN[case]
    rng = np.random.default_rng(8)
    xv = rng.integers(0, 10, shape).astype(np.int32) if dt == "int32" \
        else rng.standard_normal(shape).astype(np.float32)

    def script(m):
        main, startup = _progs(m)
        with m.st.program_guard(main, startup):
            out = build(m, m.st.data("x", shape, dt))
        exe = m.st.Executor()
        exe.run(startup)
        return exe.run(main, feed={"x": xv}, fetch_list=[out])

    _both(script)


# ------------------------------------------------- the recorder's cost


def test_the_recorder_is_inactive_outside_a_program(monkeypatch):
    assert tcore._static_recorder is None
    main = tst.Program()
    with tst.program_guard(main):
        assert tcore._static_recorder is not None
        tst.data("x", [2])
    assert tcore._static_recorder is None
    pt.enable_static()
    try:
        assert tcore._static_recorder is not None
    finally:
        pt.disable_static()
    assert tcore._static_recorder is None

    def refuse(*a, **k):
        raise AssertionError("the eager path asked the recorder")

    from paddle_tpu_torch.static import graph
    monkeypatch.setattr(graph._recorder, "active", refuse)
    x = pt.to_tensor([1.0, 2.0])
    np.testing.assert_allclose((pt.exp(x) * 2).numpy(),
                               np.exp([1.0, 2.0]) * 2, rtol=1e-6)

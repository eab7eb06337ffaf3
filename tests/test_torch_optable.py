"""The port's op table on the CPU against the JAX package's.

Every row of ``paddle_tpu_torch/ops/optable.py`` (a copy of the
reference's ``paddle_tpu/ops/optable.py``) runs through both packages'
flat namespaces on the same numpy inputs: the port's values within the
row's ``atol`` / ``rtol`` of the JAX package's and of the row's numpy
``ref``, dtypes equal, bool and integer results exact. Every
differentiable float row (a real floating input and a real floating
output) also runs backward: ``Tensor.backward`` of ``sum(out * w)``, w
drawn from seed 0, against the JAX package's tape, each input's
gradient within ``max(row atol, 1e-5)`` and the row's ``rtol``, and
None where the JAX package gives None.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu.ops import optable as ref_optable
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.ops.optable import TABLE, coverage_names

# the JAX package records no gradient for these (a creation op, or numpy
# on the host) or its tape raises; the port gives None too
# (test_rows_without_a_reference_gradient), except masked_select, which
# it differentiates (torch's gather; ROADMAP Queue 3)
NO_REF_GRAD = {"nextafter", "masked_select", "unique",
               "unique_consecutive", "zeros_like", "ones_like", "full_like",
               "assign"}
# torch has no derivative of gammainc / gammaincc in the shape parameter
# x: the port takes x as a constant (ROADMAP Queue 3); y's gradient is
# compared, x's is pinned as None
X_CONSTANT = {"gammainc", "gammaincc"}


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    """The port on the CPU (the default place is the card), one torch
    thread (the test workers share the machine's cores)."""
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


def _call(mod, case, tensors):
    op = getattr(mod, case.name)
    if case.call is not None:
        return case.call(op, tensors, case.attrs)
    return op(*tensors, **case.attrs)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for e in x for leaf in _leaves(e)]
    return [x]


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _dname(x):
    if isinstance(x, pt.Tensor):
        return dtype_name(x.dtype)
    if isinstance(x, jt.Tensor):
        return np.dtype(x.dtype).name
    return type(x).__name__


def _assert_close(got, want, case, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=what)
    elif np.issubdtype(want.dtype, np.complexfloating) or \
            np.issubdtype(got.dtype, np.complexfloating):
        np.testing.assert_allclose(got.astype(np.complex128),
                                   want.astype(np.complex128),
                                   atol=case.atol, rtol=case.rtol,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64),
                                   atol=case.atol, rtol=case.rtol,
                                   err_msg=what)


def _is_real_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _diff_rows():
    rows = []
    for case in TABLE:
        if case.name in NO_REF_GRAD or not case.inputs:
            continue
        ins = [g() for g in case.inputs.values()]
        outs = _leaves(case.ref(*ins))
        if any(_is_real_float(a) for a in ins) and \
                any(_is_real_float(o) for o in outs):
            rows.append(case)
    return rows


DIFF_ROWS = _diff_rows()


def test_table_is_the_references():
    assert [c.case_id for c in TABLE] == \
        [c.case_id for c in ref_optable.TABLE]
    assert len(TABLE) >= 300
    missing = [n for n in coverage_names() if not hasattr(pt, n)]
    assert not missing, missing


@pytest.mark.parametrize("case", TABLE, ids=[c.case_id for c in TABLE])
def test_row_matches_jax_and_numpy(case):
    np_inputs = [gen() for gen in case.inputs.values()]
    got = _leaves(_call(pt, case, [pt.to_tensor(v) for v in np_inputs]))
    want = _leaves(_call(jt, case, [jt.to_tensor(v) for v in np_inputs]))
    ref = _leaves(case.ref(*np_inputs) if case.inputs else case.ref())
    assert len(got) == len(want) == len(ref), (len(got), len(want),
                                               len(ref))
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        assert _dname(g) == _dname(w), (i, _dname(g), _dname(w))
        assert isinstance(g, pt.Tensor) == isinstance(w, jt.Tensor), i
        _assert_close(_np(g), _np(w), case, f"output {i} against JAX")
        _assert_close(_np(g), r, case, f"output {i} against numpy")


def _backward(mod, case, np_inputs, weights):
    tensors = [mod.to_tensor(v, stop_gradient=not _is_real_float(v))
               for v in np_inputs]
    outs = _leaves(_call(mod, case, tensors))
    loss = None
    for o, w in zip(outs, weights):
        if w is None or not isinstance(o, mod.Tensor):
            continue
        part = (o * mod.to_tensor(w)).sum()
        loss = part if loss is None else loss + part
    if loss is not None:
        loss.backward()
    return [None if t.grad is None else _np(t.grad) for t in tensors]


@pytest.mark.parametrize("case", DIFF_ROWS,
                         ids=[c.case_id for c in DIFF_ROWS])
def test_row_gradient_matches_jax(case):
    np_inputs = [gen() for gen in case.inputs.values()]
    rng = np.random.RandomState(0)
    weights = [rng.uniform(0.5, 1.5, np.shape(o)).astype(np.float32)
               if _is_real_float(o) else None
               for o in _leaves(case.ref(*np_inputs))]
    got = _backward(pt, case, np_inputs, weights)
    want = _backward(jt, case, np_inputs, weights)
    assert any(w is not None for w in want), "no reference gradient"
    atol = max(case.atol, 1e-5)
    for i, (g, w) in enumerate(zip(got, want)):
        if case.name in X_CONSTANT and i == 0:
            assert g is None and w is not None
            continue
        if g is None and w is not None:
            # torch leaves an input its op does not differentiate through
            # (a condition, a shape) without a gradient; jnp gives zeros
            assert not np.any(w), (i, "port None, JAX nonzero")
            continue
        assert (g is None) == (w is None), (i, g is None, w is None)
        if w is not None:
            assert g.shape == w.shape, (i, g.shape, w.shape)
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), atol=atol,
                                       rtol=case.rtol,
                                       err_msg=f"gradient of input {i}")


NO_GRAD_ROWS = [c for c in TABLE if c.name in NO_REF_GRAD]


@pytest.mark.parametrize("case", NO_GRAD_ROWS,
                         ids=[c.case_id for c in NO_GRAD_ROWS])
def test_rows_without_a_reference_gradient(case):
    np_inputs = [gen() for gen in case.inputs.values()]
    rng = np.random.RandomState(0)
    weights = [rng.uniform(0.5, 1.5, np.shape(o)).astype(np.float32)
               if _is_real_float(o) else None
               for o in _leaves(case.ref(*np_inputs))]
    got = _backward(pt, case, np_inputs, weights)
    try:
        want = _backward(jt, case, np_inputs, weights)
    except Exception:           # the JAX tape has no rule for the op
        want = [None] * len(np_inputs)
    assert all(w is None for w in want), case.case_id
    if case.name == "masked_select":
        mask = np_inputs[1]
        np.testing.assert_array_equal(got[0], mask.astype(np.float32)
                                      * got[0])
        assert np.count_nonzero(got[0]) == np.count_nonzero(mask)
    else:
        assert all(g is None for g in got), case.case_id

"""The tail of the port's ``nn`` (``paddle_tpu_torch/nn/layers_tail.py``
and the ops of ``nn.functional`` it and the flat namespace call) against
the JAX package's, on the CPU: ``tests/test_functional_tail.py``'s ops,
each on the same inputs made from a seed with numpy.

Every op runs through the paddle tensor API of both packages (``m`` is
``paddle_tpu`` or ``paddle_tpu_torch``): its outputs within ``TOL``, and
where the reference differentiates it, the gradients of a weighted sum
of its float outputs with respect to each float input within ``TOL``
of that gradient's largest value. ``feature_alpha_dropout``'s mask is
the reference's bit for bit under the same ``seed()``. The layers of
``layers_tail`` run on the same inputs (``HSigmoidLoss``'s weights
carried across), and ``dynamic_decode``'s beam search over a bridged
GRU cell gives the reference's ids and lengths.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


def _np(t):
    if torch.is_tensor(t):
        return t.detach().double().numpy()
    return np.asarray(t.numpy(), dtype=np.float64)


def _float(a):
    return isinstance(a, np.ndarray) and a.dtype.kind == "f"


def run(m, fn, args, kw, diff, cots):
    """``fn(m)(*args, **kw)`` on tensors of package ``m``: (outputs,
    gradients of ``sum(out * cot)`` over the float outputs w.r.t. the
    inputs at ``diff``, the cotangents ``cots(outputs)``)."""
    ts = [m.to_tensor(a.copy(), stop_gradient=i not in diff)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    out = fn(m)(*ts, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    grads = []
    if diff:
        loss = None
        for o, c in zip(outs, cots(outs)):
            if c is None:
                continue
            term = (o * m.to_tensor(c)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [ts[i].grad for i in diff]
    return outs, grads


def check(fn, args, kw=None, diff=(), tol=TOL, seed=0):
    """``fn`` on both packages: outputs within ``tol``, gradients within
    ``tol`` of each one's largest value."""
    kw = kw or {}
    rng = np.random.RandomState(seed)
    made = []

    def cots(outs):
        if not made:
            made.extend(
                rng.standard_normal(np.shape(o.numpy())).astype(np.float32)
                if np.asarray(o.numpy()).dtype.kind == "f" else None
                for o in outs)
        return made

    jt.seed(seed)
    np.random.seed(seed)
    jouts, jgrads = run(jt, fn, args, kw, diff, cots)
    pt.seed(seed)
    np.random.seed(seed)
    touts, tgrads = run(pt, fn, args, kw, diff, cots)
    assert len(touts) == len(jouts)
    for i, (a, b) in enumerate(zip(touts, jouts)):
        assert tuple(a.shape) == tuple(b.shape), (i, a.shape, b.shape)
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                                   err_msg=f"output {i}")
    for i, (a, b) in zip(diff, zip(tgrads, jgrads)):
        want = _np(b)
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(_np(a), want, rtol=0, atol=tol * scale,
                                   err_msg=f"grad of input {i}")
    return touts


def F(name):
    return lambda m: getattr(m.nn.functional, name)


R = np.random.RandomState(1234)


def _r(*shape, lo=None, hi=None):
    if lo is not None:
        return R.uniform(lo, hi, size=shape).astype(np.float32)
    return R.standard_normal(shape).astype(np.float32)


def _i(hi, *shape, lo=0):
    return R.randint(lo, hi, size=shape).astype(np.int32)


def _pool_indices(x, window):
    """Flat argmax indices of non-overlapping max pooling with
    ``window`` (kernel = stride) over x's trailing dims, and the pooled
    values."""
    spatial = x.shape[2:]
    out_sp = tuple(s // w for s, w in zip(spatial, window))
    vals = np.zeros(x.shape[:2] + out_sp, np.float32)
    idx = np.zeros(x.shape[:2] + out_sp, np.int32)
    for pos in np.ndindex(*out_sp):
        sl = tuple(slice(p * w, (p + 1) * w) for p, w in zip(pos, window))
        win = x[(slice(None), slice(None)) + sl].reshape(x.shape[:2] + (-1,))
        a = win.argmax(-1)
        local = np.unravel_index(a, window)
        glob = [p * w + lo for p, w, lo in zip(pos, window, local)]
        idx[(slice(None), slice(None)) + pos] = np.ravel_multi_index(
            glob, spatial)
        vals[(slice(None), slice(None)) + pos] = win.max(-1)
    return vals, idx


_x4 = _r(2, 3, 4, 4)
_v2, _ix2 = _pool_indices(_x4, (2, 2))
_v1, _ix1 = _pool_indices(_r(2, 3, 6), (2,))
_v3, _ix3 = _pool_indices(_r(1, 2, 4, 4, 4), (2, 2, 2))
_csr_cols = np.array([[[0, 1, 1, 2, 0, 2, 3, 3],
                       [0, 0, 1, 2, 3, 1, 2, 3]]], np.int32)
_csr_off = np.array([[[0, 2, 4, 6, 8], [0, 1, 3, 5, 8]]], np.int32)

CASES = {
    "affine_grid": (F("affine_grid"), [_r(2, 2, 3), [2, 3, 4, 5]], {},
                    (0,)),
    "affine_grid_half_pixel": (F("affine_grid"), [_r(2, 2, 3),
                                                  [2, 3, 4, 5]],
                               {"align_corners": False}, (0,)),
    "temporal_shift": (F("temporal_shift"), [_r(4, 8, 3, 3), 2],
                       {"shift_ratio": 0.25}, (0,)),
    "zeropad2d": (F("zeropad2d"), [_r(1, 2, 3, 3), [1, 2, 0, 1]], {},
                  (0,)),
    "zeropad2d_nhwc": (F("zeropad2d"), [_r(1, 3, 3, 2), [1, 0, 2, 1]],
                       {"data_format": "NHWC"}, (0,)),
    "pixel_unshuffle": (F("pixel_unshuffle"), [_r(1, 2, 4, 6), 2], {},
                        (0,)),
    "channel_shuffle": (F("channel_shuffle"), [_r(1, 6, 2, 2), 3], {},
                        (0,)),
    "pairwise_distance": (F("pairwise_distance"), [_r(4, 5), _r(4, 5)],
                          {}, (0, 1)),
    "pairwise_distance_p3": (F("pairwise_distance"), [_r(4, 5), _r(4, 5)],
                             {"p": 3.0, "keepdim": True}, (0, 1)),
    "unfold": (F("unfold"), [_r(2, 3, 6, 7), 3],
               {"strides": 2, "paddings": 1}, (0,)),
    "unfold_dilated": (F("unfold"), [_r(1, 2, 7, 7), [2, 3]],
                       {"dilations": 2}, (0,)),
    "fold": (F("fold"), [_r(2, 3 * 2 * 2, 4 * 5), [5, 6], 2], {}, (0,)),
    "fold_strided": (F("fold"), [_r(1, 2 * 9, 9), [6, 6], 3],
                     {"strides": 2, "paddings": 1}, (0,)),
    "max_unpool1d": (F("max_unpool1d"), [_v1, _ix1, 2], {}, (0,)),
    "max_unpool2d": (F("max_unpool2d"), [_v2, _ix2, 2], {}, (0,)),
    "max_unpool3d": (F("max_unpool3d"), [_v3, _ix3, 2], {}, (0,)),
    "adaptive_max_pool3d": (F("adaptive_max_pool3d"),
                            [_r(1, 2, 4, 6, 4), [2, 3, 2]], {}, (0,)),
    "adaptive_max_pool3d_uneven": (F("adaptive_max_pool3d"),
                                   [_r(1, 2, 5, 7, 4), [3, 4, 3]], {},
                                   (0,)),
    "square_error_cost": (F("square_error_cost"), [_r(3, 4), _r(3, 4)],
                          {}, (0, 1)),
    "sigmoid_focal_loss": (F("sigmoid_focal_loss"),
                           [_r(4, 3), _i(2, 4, 3).astype(np.float32)], {},
                           (0,)),
    "sigmoid_focal_loss_mean": (F("sigmoid_focal_loss"),
                                [_r(4, 3), _i(2, 4, 3).astype(np.float32)],
                                {"alpha": -1.0, "gamma": 1.5,
                                 "reduction": "mean"}, (0,)),
    "huber_loss": (F("huber_loss"), [_r(3, 4), _r(3, 4)], {"delta": 0.7},
                   (0, 1)),
    "soft_margin_loss": (F("soft_margin_loss"),
                         [_r(3, 4), np.sign(_r(3, 4))], {}, (0,)),
    "multi_label_soft_margin_loss": (
        F("multi_label_soft_margin_loss"),
        [_r(3, 4), _i(2, 3, 4).astype(np.float32), _r(4, lo=0.5, hi=2.0)],
        {}, (0,)),
    "poisson_nll_loss": (F("poisson_nll_loss"),
                         [_r(3, 4), _i(5, 3, 4).astype(np.float32)],
                         {"full": True}, (0,)),
    "poisson_nll_loss_rates": (F("poisson_nll_loss"),
                               [_r(3, 4, lo=0.1, hi=3.0),
                                _i(5, 3, 4).astype(np.float32)],
                               {"log_input": False, "reduction": "sum"},
                               (0,)),
    "gaussian_nll_loss": (F("gaussian_nll_loss"),
                          [_r(3, 4), _r(3, 4), _r(3, 4, lo=0.2, hi=2.0)],
                          {"full": True}, (0, 1, 2)),
    "log_loss": (F("log_loss"), [_r(4, 1, lo=0.05, hi=0.95),
                                 _i(2, 4, 1).astype(np.float32)], {},
                 (0,)),
    "dice_loss": (F("dice_loss"), [_r(3, 4, 5, lo=0.0, hi=1.0),
                                   _i(5, 3, 4, 1)], {}, (0,)),
    "npair_loss": (F("npair_loss"), [_r(4, 6), _r(4, 6),
                                     np.array([0, 1, 0, 2], np.int32)], {},
                   (0, 1)),
    "triplet_margin_with_distance_loss": (
        F("triplet_margin_with_distance_loss"), [_r(4, 5), _r(4, 5),
                                                 _r(4, 5)],
        {"swap": True, "margin": 2.0}, (0, 1, 2)),
    "softmax_with_cross_entropy": (
        F("softmax_with_cross_entropy"),
        [_r(4, 5), np.array([[1], [4], [-100], [0]], np.int32)], {}, (0,)),
    "softmax_with_cross_entropy_soft": (
        F("softmax_with_cross_entropy"),
        [_r(4, 5), _r(4, 5, lo=0.0, hi=0.4)],
        {"soft_label": True, "return_softmax": True}, (0,)),
    "margin_cross_entropy": (F("margin_cross_entropy"),
                             [_r(4, 6, lo=-0.95, hi=0.95),
                              np.array([0, 3, 5, 1], np.int32)],
                             {"return_softmax": True}, (0,)),
    "margin_cross_entropy_none": (F("margin_cross_entropy"),
                                  [_r(4, 6, lo=-0.95, hi=0.95),
                                   np.array([2, 2, 0, 4], np.int32)],
                                  {"margin1": 0.9, "margin3": 0.1,
                                   "scale": 8.0, "reduction": "none"},
                                  (0,)),
    "multi_margin_loss": (F("multi_margin_loss"),
                          [_r(4, 5), np.array([0, 4, 2, 2], np.int32)], {},
                          (0,)),
    "multi_margin_loss_p2": (F("multi_margin_loss"),
                             [_r(4, 5), np.array([1, 3, 0, 2], np.int32),
                              2, 0.8, _r(5, lo=0.5, hi=1.5)], {}, (0,)),
    "hsigmoid_loss": (F("hsigmoid_loss"),
                      [_r(4, 6), np.array([0, 6, 3, 5], np.int32), 7,
                       _r(6, 6), _r(6, 1)], {}, (0, 3, 4)),
    "gather_tree": (F("gather_tree"), [_i(9, 4, 2, 3), _i(3, 4, 2, 3)], {},
                    ()),
    "class_center_sample": (F("class_center_sample"),
                            [np.array([3, 7, 3, 1, 9, 7], np.int32), 12, 7],
                            {}, ()),
    "sparse_attention": (F("sparse_attention"),
                         [_r(1, 2, 4, 8), _r(1, 2, 4, 8), _r(1, 2, 4, 8),
                          _csr_off, _csr_cols], {}, (0, 1, 2)),
    "sequence_mask": (F("sequence_mask"), [np.array([2, 0, 5], np.int32)],
                      {"maxlen": 6}, ()),
    "sequence_mask_auto": (F("sequence_mask"),
                           [np.array([[1, 3], [4, 2]], np.int32)], {}, ()),
}

_GRID = _r(2, 4, 3, 2, lo=-1.2, hi=1.2)
for _mode in ("bilinear", "nearest"):
    for _pad in ("zeros", "border", "reflection"):
        for _align in (True, False):
            CASES[f"grid_sample_{_mode}_{_pad}_{int(_align)}"] = (
                F("grid_sample"), [_r(2, 3, 5, 6), _GRID],
                {"mode": _mode, "padding_mode": _pad,
                 "align_corners": _align},
                (0, 1) if _mode == "bilinear" else (0,))

_CTC_LP = _r(12, 3, 5)
_CTC_LAB = np.array([[1, 2, 2, 3], [4, 1, 4, 0], [2, 0, 0, 0]], np.int32)
_CTC_IL = np.array([12, 10, 7], np.int32)
_CTC_LL = np.array([4, 3, 0], np.int32)
for _red in ("mean", "sum", "none"):
    CASES[f"ctc_loss_{_red}"] = (
        F("ctc_loss"), [_CTC_LP, _CTC_LAB, _CTC_IL, _CTC_LL],
        {"reduction": _red}, (0,))
CASES["ctc_loss_norm_by_times"] = (
    F("ctc_loss"), [_CTC_LP, _CTC_LAB, _CTC_IL, _CTC_LL],
    {"blank": 0, "reduction": "none", "norm_by_times": True}, (0,))

_RNNT = [_r(2, 5, 4, 6), np.array([[1, 2, 5], [3, 3, 0]], np.int32),
         np.array([5, 4], np.int32), np.array([3, 2], np.int32)]
CASES["rnnt_loss"] = (F("rnnt_loss"), _RNNT, {}, (0,))
CASES["rnnt_loss_fastemit"] = (F("rnnt_loss"), _RNNT,
                               {"fastemit_lambda": 0.001,
                                "reduction": "none"}, (0,))
CASES["rnnt_loss_sum_blank"] = (F("rnnt_loss"), _RNNT,
                                {"blank": 5, "reduction": "sum"}, (0,))


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_is_the_references(case):
    fn, args, kw, diff = CASES[case]
    check(fn, args, kw, diff)


def test_feature_alpha_dropout_mask_bit_for_bit():
    """Same ``seed()``, same channels dropped: at x = 0 an output is
    ``b`` where kept and ``a * alpha_p + b`` where dropped."""
    x = _r(4, 6, 3, 2)
    for p in (0.3, 0.5, 0.8):
        outs = check(F("feature_alpha_dropout"), [x], {"p": p}, (0,),
                     seed=int(p * 10))
        assert outs[0].shape == [4, 6, 3, 2]
        z = np.zeros((64, 16, 2), np.float32)
        pt.seed(5)
        got = pt.nn.functional.feature_alpha_dropout(pt.to_tensor(z), p=p)
        jt.seed(5)
        want = jt.nn.functional.feature_alpha_dropout(jt.to_tensor(z), p=p)
        g, w = _np(got), _np(want)
        kept_g = g == g.max() if g.max() != g.min() else g == g
        kept_w = w == w.max() if w.max() != w.min() else w == w
        np.testing.assert_array_equal(kept_g, kept_w)
        assert 0 < kept_g.mean() < 1
    y = pt.nn.functional.feature_alpha_dropout(pt.to_tensor(x), p=0.5,
                                               training=False)
    np.testing.assert_array_equal(_np(y), x)


def test_functional_aliases_are_the_references():
    x = _r(3, 4)
    for name in ("tanh", "sigmoid", "log_sigmoid"):
        check(F(name), [x], {}, (0,))
    check(F("one_hot"), [np.array([0, 3, 1], np.int32), 4], {}, ())
    check(F("diag_embed"), [_r(2, 3)], {}, (0,))
    check(F("pad"), [_r(1, 2, 3, 3), [1, 0, 2, 1]], {}, (0,))
    for name in ("relu_", "tanh_", "softmax_", "elu_"):
        got = getattr(pt.nn.functional, name)(pt.to_tensor(x))
        want = getattr(jt.nn.functional, name)(jt.to_tensor(x))
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
        # a torch tensor gets the op's value, the input left as it is
        t = torch.tensor(x)
        np.testing.assert_allclose(
            _np(getattr(pt.nn.functional, name)(t)), _np(want), rtol=TOL,
            atol=TOL)
        np.testing.assert_array_equal(t.numpy(), x)


def test_functional_surface_is_the_references():
    import types

    import paddle_tpu.nn.functional as jf
    import paddle_tpu_torch.nn.functional as tf

    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}
    # the reference's module imports, and the port's own entry points
    assert names(jf) - names(tf) == {"register", "unwrap"}
    assert names(tf) - names(jf) == {
        "OPS", "batch_norm_func", "cross_entropy_soft",
        "cross_entropy_with_softmax", "interpolate_nearest",
        "rms_norm_ref"}


def test_torch_tensors_in_torch_tensors_out():
    """The train step's form: plain torch tensors call the op straight
    and get torch tensors back."""
    f = pt.nn.functional
    out = f.ctc_loss(torch.tensor(_CTC_LP), torch.tensor(_CTC_LAB),
                     torch.tensor(_CTC_IL), torch.tensor(_CTC_LL))
    assert torch.is_tensor(out) and out.shape == ()
    out = f.grid_sample(torch.tensor(_r(1, 2, 3, 3)),
                        torch.tensor(_r(1, 2, 2, 2)))
    assert torch.is_tensor(out) and tuple(out.shape) == (1, 2, 2, 2)
    assert pt.ctc_loss is f.ctc_loss and pt.unfold is f.unfold


# ============================================================== layers
def L(name, *ctor, **ctor_kw):
    return lambda m: getattr(m.nn, name)(*ctor, **ctor_kw)


LAYER_CASES = {
    "Unfold": (L("Unfold", 3, 2, 1), [_r(2, 3, 6, 7)]),
    "Fold": (L("Fold", [5, 6], 2), [_r(2, 12, 20)]),
    "PairwiseDistance": (L("PairwiseDistance", 3.0, keepdim=True),
                         [_r(4, 5), _r(4, 5)]),
    "Softmax2D": (L("Softmax2D"), [_r(2, 3, 4, 4)]),
    "Silu": (L("Silu"), [_r(3, 4)]),
    "CTCLoss": (L("CTCLoss", blank=0, reduction="sum"),
                [_CTC_LP, _CTC_LAB, _CTC_IL, _CTC_LL]),
    "RNNTLoss": (L("RNNTLoss"), _RNNT),
    "PixelUnshuffle": (L("PixelUnshuffle", 2), [_r(1, 2, 4, 6)]),
    "ChannelShuffle": (L("ChannelShuffle", 3), [_r(1, 6, 2, 2)]),
    "ZeroPad2D": (L("ZeroPad2D", [1, 2, 0, 1]), [_r(1, 2, 3, 3)]),
    "MaxUnPool1D": (L("MaxUnPool1D", 2), [_v1, _ix1]),
    "MaxUnPool2D": (L("MaxUnPool2D", 2), [_v2, _ix2]),
    "MaxUnPool3D": (L("MaxUnPool3D", 2), [_v3, _ix3]),
    "MultiLabelSoftMarginLoss": (L("MultiLabelSoftMarginLoss"),
                                 [_r(3, 4), _i(2, 3, 4).astype(np.float32)]),
    "MultiMarginLoss": (L("MultiMarginLoss", p=2, margin=0.5),
                        [_r(4, 5), np.array([0, 4, 2, 2], np.int32)]),
    "TripletMarginWithDistanceLoss": (
        L("TripletMarginWithDistanceLoss", swap=True),
        [_r(4, 5), _r(4, 5), _r(4, 5)]),
    "SoftMarginLoss": (L("SoftMarginLoss", reduction="none"),
                       [_r(3, 4), np.sign(_r(3, 4))]),
    "AdaptiveMaxPool3D": (L("AdaptiveMaxPool3D", [2, 3, 2]),
                          [_r(1, 2, 4, 6, 4)]),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_is_the_references(case):
    make, args = LAYER_CASES[case]
    diff = (0,) if _float(args[0]) else ()

    def fn(m):
        layer = make(m)
        return lambda *a: layer(*a)
    check(fn, args, {}, diff)


def test_hsigmoid_loss_layer_with_the_references_weights():
    jl = jt.nn.HSigmoidLoss(6, 7)
    tl = pt.nn.HSigmoidLoss(6, 7)
    assert set(tl.state_dict()) == set(jl.state_dict()) == {"weight",
                                                              "bias"}
    tl.set_state_dict({k: np.array(v.numpy())
                       for k, v in jl.state_dict().items()})
    x = _r(4, 6)
    lab = np.array([0, 6, 3, 5], np.int32)
    np.testing.assert_allclose(_np(tl(pt.to_tensor(x), pt.to_tensor(lab))),
                               _np(jl(jt.to_tensor(x), jt.to_tensor(lab))),
                               rtol=TOL, atol=TOL)
    assert pt.nn.HSigmoidLoss(6, 7, bias_attr=False).bias is None


@pytest.mark.parametrize("beam", [1, 3])
def test_dynamic_decode_beam_search_is_the_references(beam):
    """``BeamSearchDecoder`` over a GRU cell with the reference's weights
    (and its embedding and output layers): the same ids and lengths."""
    V, E, H, B = 7, 4, 5, 2
    jt.seed(3)
    jcell, jemb, jout = (jt.nn.GRUCell(E, H), jt.nn.Embedding(V, E),
                         jt.nn.Linear(H, V))
    pt.seed(3)
    tcell, temb, tout = (pt.nn.GRUCell(E, H), pt.nn.Embedding(V, E),
                         pt.nn.Linear(H, V))
    for j, t in ((jcell, tcell), (jemb, temb), (jout, tout)):
        t.set_state_dict({k: np.array(v.numpy())
                          for k, v in j.state_dict().items()})
    h0 = _r(B, H)
    outs = []
    for m, cell, emb, out in ((pt, tcell, temb, tout),
                              (jt, jcell, jemb, jout)):
        dec = m.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                     beam_size=beam, embedding_fn=emb,
                                     output_fn=out)
        ids, lengths = m.nn.dynamic_decode(dec, inits=m.to_tensor(h0),
                                           max_step_num=6)
        outs.append((np.asarray(ids.numpy()), np.asarray(lengths.numpy())))
    (ti, tl), (ji, jl) = outs
    assert ti.shape == (B, beam, ji.shape[-1])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)

"""The port's detection operators (``paddle_tpu_torch/vision/ops.py``)
against the JAX package's, on the CPU, case by case from numpy inputs
drawn from a seed.

The host ops (``nms``, ``matrix_nms``, ``prior_box``, ``box_coder``,
``yolo_box``, ``distribute_fpn_proposals``, ``generate_proposals``) are
numpy in both packages: their outputs are held equal (``nms``'s indices
exactly, ties included, since both keep numpy's ``argsort(-score)`` in
float64), floats within ``HOST_TOL``. The differentiable ops
(``roi_align``, ``roi_pool``, ``psroi_pool``, ``yolo_loss``,
``deform_conv2d``) are compositions of f32 arithmetic in both: values
within ``TOL`` and the gradients of a seeded weighted sum of the output
within ``GRAD_TOL``, each of its tensor's largest magnitude. ``read_file``
and ``decode_jpeg`` go through PIL in both: the bytes equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.vision import ops as TV

HOST_TOL = 1e-6
TOL = 1e-5
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


def _rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    # an empty RoI bin is -inf in both
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    got, want = got[fin], want[fin]
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, scale)


def run_both(op, arrays, kwargs, diff):
    """``op`` of both packages on ``arrays`` (numpy, the tensors'
    positional arguments; ``None`` passes through), then the gradients of
    ``sum(out * w)`` (``w`` seeded) for the positions in ``diff``:
    ``(out_ref, out_port, grads_ref, grads_port)``."""
    jargs = [None if a is None else
             jt.to_tensor(a, stop_gradient=i not in diff)
             for i, a in enumerate(arrays)]
    targs = [None if a is None else
             pt.to_tensor(a, stop_gradient=i not in diff)
             for i, a in enumerate(arrays)]
    jout = getattr(JV, op)(*jargs, **kwargs)
    tout = getattr(TV, op)(*targs, **kwargs)
    w = np.random.default_rng(11).standard_normal(
        tuple(jout.shape)).astype(np.float32)
    jgrads = tgrads = []
    if diff:
        (jout * jt.to_tensor(w)).sum().backward()
        (tout * pt.to_tensor(w)).sum().backward()
        jgrads = [jargs[i].grad.numpy() for i in diff]
        tgrads = [targs[i].grad.numpy() for i in diff]
    return jout.numpy(), tout.numpy(), jgrads, tgrads


def check(op, arrays, kwargs, diff=()):
    jo, to, jg, tg = run_both(op, arrays, kwargs, diff)
    _rel(to, jo, TOL)
    for a, b in zip(tg, jg):
        _rel(a, b, GRAD_TOL)


def random_boxes(rng, n, size, min_wh=1.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(min_wh, size * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ------------------------------------------------------------------ NMS


@pytest.mark.parametrize("cats", [False, True])
@pytest.mark.parametrize("top_k", [None, 7])
def test_nms_indices_equal_with_ties(cats, top_k):
    rng = np.random.default_rng(0)
    boxes = random_boxes(rng, 60, 40.0)
    scores = rng.choice(np.linspace(0.1, 0.9, 9), 60).astype(np.float32)
    kw = {"top_k": top_k}
    jargs = [jt.to_tensor(boxes), 0.4, jt.to_tensor(scores)]
    targs = [pt.to_tensor(boxes), 0.4, pt.to_tensor(scores)]
    if cats:
        c = rng.integers(0, 3, 60).astype(np.int64)
        jargs.append(jt.to_tensor(c))
        targs.append(pt.to_tensor(c))
        kw["categories"] = [0, 1, 2]
    want = JV.nms(*jargs, **kw).numpy()
    got = TV.nms(*targs, **kw).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_nms_without_scores_and_on_torch_tensors():
    boxes = random_boxes(np.random.default_rng(1), 20, 30.0)
    want = JV.nms(jt.to_tensor(boxes), 0.3).numpy()
    got = TV.nms(torch.tensor(boxes), 0.3)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms_matches(gaussian):
    rng = np.random.default_rng(2)
    boxes = random_boxes(rng, 12, 30.0)[None]
    scores = rng.uniform(0, 1, (1, 3, 12)).astype(np.float32)
    args = (0.2, 0.05, 10, 8)
    kw = dict(use_gaussian=gaussian, return_index=True)
    want = JV.matrix_nms(jt.to_tensor(boxes), jt.to_tensor(scores), *args,
                         **kw)
    got = TV.matrix_nms(pt.to_tensor(boxes), pt.to_tensor(scores), *args,
                        **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=HOST_TOL,
                                   atol=HOST_TOL)


# ------------------------------------------------------------- RoI ops


def roi_inputs(seed=3, scale=1.0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((2, 4, 12, 14)).astype(np.float32)
    boxes = random_boxes(rng, 6, 12.0 / scale, min_wh=0.5)
    # a box past the map's edge and a degenerate one
    boxes[1] = [9.5 / scale, 8.0 / scale, 16.0 / scale, 15.0 / scale]
    boxes[4] = [3.0, 3.0, 3.2, 3.1]
    return feat, boxes, np.array([3, 3], np.int32)


@pytest.mark.parametrize("output_size,scale,ratio,aligned", [
    (3, 1.0, -1, True), ((2, 3), 0.5, -1, False), (2, 1.0, 2, True)])
def test_roi_align_values_and_grads(output_size, scale, ratio, aligned):
    feat, boxes, num = roi_inputs(scale=scale)
    check("roi_align", [feat, boxes, num],
          dict(output_size=output_size, spatial_scale=scale,
               sampling_ratio=ratio, aligned=aligned), diff=(0, 1))


def test_roi_align_static_build_takes_the_fixed_grid(monkeypatch):
    """Under a static build the boxes are fed anew at each run, so the
    grid is the fixed 2 x 2 (the reference's fallback)."""
    from paddle_tpu_torch.static import graph
    feat, boxes, num = roi_inputs()
    want = JV.roi_align(jt.to_tensor(feat), jt.to_tensor(boxes),
                        jt.to_tensor(num), 3, sampling_ratio=2).numpy()
    adaptive = TV.roi_align(pt.to_tensor(feat), pt.to_tensor(boxes),
                            pt.to_tensor(num), 3).numpy()
    monkeypatch.setattr(graph, "in_static_build", lambda: True)
    got = TV.roi_align(pt.to_tensor(feat), pt.to_tensor(boxes),
                       pt.to_tensor(num), 3).numpy()
    _rel(got, want, TOL)
    assert np.abs(adaptive - got).max() > 1e-3


def test_roi_pool_values_and_grads():
    feat, boxes, num = roi_inputs(seed=4)
    check("roi_pool", [feat, boxes, num],
          dict(output_size=(3, 2), spatial_scale=1.0), diff=(0,))


def test_psroi_pool_values_and_grads():
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 8, 10, 10)).astype(np.float32)
    boxes = random_boxes(rng, 4, 10.0)
    check("psroi_pool", [feat, boxes, np.array([2, 2], np.int32)],
          dict(output_size=2, spatial_scale=1.0), diff=(0,))


def test_roi_layers_match_functions():
    feat, boxes, num = roi_inputs(seed=6)
    args = [pt.to_tensor(feat), pt.to_tensor(boxes), pt.to_tensor(num)]
    for layer, fn, size in ((TV.RoIAlign, TV.roi_align, 3),
                            (TV.RoIPool, TV.roi_pool, 2),
                            (TV.PSRoIPool, TV.psroi_pool, 1)):
        np.testing.assert_array_equal(layer(size)(*args).numpy(),
                                      fn(*args, size).numpy())


# ------------------------------------------------------------- anchors


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0], aspect_ratios=[1.0, 2.0], flip=True),
    dict(min_sizes=[8.0, 12.0], max_sizes=[16.0, 20.0],
         aspect_ratios=[1.0, 2.0, 0.5], clip=True),
    dict(min_sizes=[8.0], max_sizes=[16.0], aspect_ratios=[1.0, 3.0],
         min_max_aspect_ratios_order=True, steps=(6.0, 6.0), offset=0.3)])
def test_prior_box_matches(kw):
    feat = np.zeros((1, 3, 3, 4), np.float32)
    img = np.zeros((1, 3, 24, 32), np.float32)
    want = JV.prior_box(jt.to_tensor(feat), jt.to_tensor(img), **kw)
    got = TV.prior_box(pt.to_tensor(feat), pt.to_tensor(img), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=HOST_TOL,
                                   atol=HOST_TOL)


@pytest.mark.parametrize("code_type,axis,normalized", [
    ("encode_center_size", 0, True), ("decode_center_size", 0, False),
    ("decode_center_size", 1, True)])
def test_box_coder_matches(code_type, axis, normalized):
    rng = np.random.default_rng(7)
    priors = random_boxes(rng, 5, 20.0)
    var = rng.uniform(0.1, 0.3, (5, 4)).astype(np.float32)
    if code_type == "encode_center_size":
        target = random_boxes(rng, 5, 20.0)
    else:
        target = (0.5 * rng.standard_normal((3, 5, 4))).astype(np.float32)
        if axis == 0:
            target = target.transpose(1, 0, 2).copy()
    kw = dict(code_type=code_type, box_normalized=normalized, axis=axis)
    want = JV.box_coder(jt.to_tensor(priors), jt.to_tensor(var),
                        jt.to_tensor(target), **kw).numpy()
    got = TV.box_coder(pt.to_tensor(priors), pt.to_tensor(var),
                       pt.to_tensor(target), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=HOST_TOL, atol=HOST_TOL)


# ------------------------------------------------------------- YOLO


@pytest.mark.parametrize("iou_aware,scale_xy,clip", [
    (False, 1.0, True), (True, 1.2, False)])
def test_yolo_box_matches(iou_aware, scale_xy, clip):
    rng = np.random.default_rng(8)
    ch = 3 * (6 if iou_aware else 5) + 3 * 2
    x = rng.standard_normal((2, ch, 3, 4)).astype(np.float32)
    size = np.array([[64, 80], [48, 64]], np.int32)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], class_num=2,
              conf_thresh=0.3, downsample_ratio=16, clip_bbox=clip,
              scale_x_y=scale_xy, iou_aware=iou_aware)
    want = JV.yolo_box(jt.to_tensor(x), jt.to_tensor(size), **kw)
    got = TV.yolo_box(pt.to_tensor(x), pt.to_tensor(size), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=HOST_TOL,
                                   atol=1e-5)


def test_yolo_loss_value_and_grad():
    rng = np.random.default_rng(9)
    x = (0.5 * rng.standard_normal((2, 3 * 7, 4, 5))).astype(np.float32)
    gt = np.array([[[0.5, 0.5, 0.2, 0.3], [0.1, 0.8, 0.1, 0.1]],
                   [[0.9, 0.2, 0.3, 0.2], [0.0, 0.0, 0.0, 0.0]]],
                  np.float32)
    label = np.array([[1, 0], [1, 0]], np.int64)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], anchor_mask=[0, 1, 2],
              class_num=2, ignore_thresh=0.5, downsample_ratio=32)
    jx = jt.to_tensor(x, stop_gradient=False)
    tx = pt.to_tensor(x, stop_gradient=False)
    want = JV.yolo_loss(jx, jt.to_tensor(gt), jt.to_tensor(label), **kw)
    got = TV.yolo_loss(tx, pt.to_tensor(gt), pt.to_tensor(label), **kw)
    _rel(got.numpy(), want.numpy(), TOL)
    want.backward()
    got.backward()
    _rel(tx.grad.numpy(), jx.grad.numpy(), GRAD_TOL)


# ---------------------------------------------------------- proposals


def test_distribute_fpn_proposals_matches():
    rng = np.random.default_rng(10)
    rois = random_boxes(rng, 30, 400.0)
    args = (2, 5, 4, 224)
    wo, wr, wn = JV.distribute_fpn_proposals(jt.to_tensor(rois), *args,
                                             rois_num=True)
    go, gr, gn = TV.distribute_fpn_proposals(pt.to_tensor(rois), *args,
                                             rois_num=True)
    for g, w in zip(go + gn + [gr], wo + wn + [wr]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_generate_proposals_matches():
    rng = np.random.default_rng(12)
    sc = rng.uniform(0, 1, (1, 3, 5, 6)).astype(np.float32)
    deltas = (0.2 * rng.standard_normal((1, 12, 5, 6))).astype(np.float32)
    anchors = (rng.uniform(0, 30, (5, 6, 3, 4))).astype(np.float32)
    anchors[..., 2:] += 20
    var = np.full((5, 6, 3, 4), 0.5, np.float32)
    size = np.array([[64, 72, 1]], np.float32)
    kw = dict(pre_nms_top_n=50, post_nms_top_n=12, nms_thresh=0.5,
              return_rois_num=True)
    want = JV.generate_proposals(*[jt.to_tensor(a) for a in
                                   (sc, deltas, size, anchors, var)], **kw)
    got = TV.generate_proposals(*[pt.to_tensor(a) for a in
                                  (sc, deltas, size, anchors, var)], **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ------------------------------------------------------------- image IO


@pytest.mark.parametrize("gray,mode", [(False, "unchanged"),
                                       (False, "gray"), (True, "rgb"),
                                       (True, "unchanged")])
def test_read_file_and_decode_jpeg_bytes_equal(tmp_path, gray, mode):
    from PIL import Image
    rng = np.random.default_rng(13)
    arr = (rng.uniform(0, 255, (10, 12) if gray else (10, 12, 3))
           ).astype(np.uint8)
    path = str(tmp_path / "img.jpg")
    Image.fromarray(arr).save(path, quality=90)
    want = JV.decode_jpeg(JV.read_file(path), mode=mode).numpy()
    raw = TV.read_file(path)
    assert raw.dtype == torch.uint8
    np.testing.assert_array_equal(raw.numpy(), JV.read_file(path).numpy())
    got = TV.decode_jpeg(raw, mode=mode).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- deform conv


@pytest.mark.parametrize("dg,groups,mask,stride,pad", [
    (1, 1, False, 1, 1), (2, 1, True, 1, 0), (1, 2, True, 2, 1)])
def test_deform_conv2d_values_and_grads(dg, groups, mask, stride, pad):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 4, 7, 6)).astype(np.float32)
    w = (0.3 * rng.standard_normal((6, 4 // groups, 3, 3))).astype(
        np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    oh = (7 + 2 * pad - 3) // stride + 1
    ow = (6 + 2 * pad - 3) // stride + 1
    off = (0.7 * rng.standard_normal((2, 2 * dg * 9, oh, ow))).astype(
        np.float32)
    m = rng.uniform(0, 1, (2, dg * 9, oh, ow)).astype(np.float32) \
        if mask else None
    jargs = [jt.to_tensor(a, stop_gradient=False) for a in (x, off, w, b)]
    targs = [pt.to_tensor(a, stop_gradient=False) for a in (x, off, w, b)]
    jm = None if m is None else jt.to_tensor(m, stop_gradient=False)
    tm = None if m is None else pt.to_tensor(m, stop_gradient=False)
    kw = dict(stride=stride, padding=pad, deformable_groups=dg,
              groups=groups)
    jout = JV.deform_conv2d(*jargs, mask=jm, **kw)
    tout = TV.deform_conv2d(*targs, mask=tm, **kw)
    _rel(tout.numpy(), jout.numpy(), TOL)
    wgt = rng.standard_normal(tuple(jout.shape)).astype(np.float32)
    (jout * jt.to_tensor(wgt)).sum().backward()
    (tout * pt.to_tensor(wgt)).sum().backward()
    pairs = list(zip(targs, jargs)) + ([(tm, jm)] if mask else [])
    for t, j in pairs:
        _rel(t.grad.numpy(), j.grad.numpy(), GRAD_TOL)


def test_deform_conv2d_layer_names_and_forward():
    pt.seed(3)
    layer = TV.DeformConv2D(4, 6, 3, padding=1)
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    assert tuple(layer.weight.shape) == (6, 4, 3, 3)
    x = np.random.default_rng(15).standard_normal(
        (1, 4, 5, 5)).astype(np.float32)
    off = np.zeros((1, 18, 5, 5), np.float32)
    got = layer(pt.to_tensor(x), pt.to_tensor(off)).numpy()
    want = torch.nn.functional.conv2d(
        torch.tensor(x), layer.weight.detach(), layer.bias.detach(),
        padding=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

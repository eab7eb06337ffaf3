"""paddle.vision.ops, the detection operators: port of
``paddle_tpu/vision/ops.py``.

The split is the reference's. The selections whose output size depends
on the data (``nms``, ``matrix_nms``, ``generate_proposals``,
``distribute_fpn_proposals``) and the box arithmetic (``prior_box``,
``box_coder``, ``yolo_box``) run on the host in numpy; ``nms`` keeps
float64 and numpy's ``argsort(-score)``, so ties break as in the
reference. ``roi_align``, ``roi_pool``, ``psroi_pool``, ``yolo_loss`` and
``deform_conv2d`` are torch compositions, differentiable through
autograd, with the reference's per-box and per-tap loops. ``read_file``
and ``decode_jpeg`` go through PIL.

Results follow ``dispatch``'s rule: torch tensors in give torch tensors
out, a paddle ``Tensor`` in (or host data alone) gives ``Tensor``s; a
result lies on its first tensor input's device, or on the default place
(the card unless ``set_device("cpu")``) when there is none.
"""
import io as _io

import numpy as np
import torch

from ..core.tensor import Tensor, as_value, dispatch, unwrap, wrap
from ..nn import functional as F
from ..nn.layer import Layer

__all__ = ["yolo_loss", "yolo_box", "prior_box", "box_coder",
           "deform_conv2d", "DeformConv2D", "distribute_fpn_proposals",
           "generate_proposals", "read_file", "decode_jpeg", "roi_pool",
           "RoIPool", "psroi_pool", "PSRoIPool", "roi_align", "RoIAlign",
           "nms", "matrix_nms"]


def _np(x):
    v = unwrap(x)
    if torch.is_tensor(v):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


def _result(arr, like=None):
    """``arr`` as a tensor beside ``like`` (see the module's rule)."""
    v = unwrap(like)
    device = v.device if torch.is_tensor(v) else None
    out = as_value(np.asarray(arr), device=device)
    if torch.is_tensor(like) and not isinstance(like, Tensor):
        return out
    return wrap(out)


def _jmax(x, v):
    """``jnp.maximum(x, v)``: at a tie each side takes half the gradient
    (``torch.clamp`` would pass it all)."""
    return torch.maximum(x, torch.tensor(v, dtype=x.dtype, device=x.device))


def _jclip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, halved gradients at
    the bounds as there."""
    return torch.minimum(_jmax(x, lo),
                         torch.tensor(hi, dtype=x.dtype, device=x.device))


def _size2(output_size):
    if isinstance(output_size, int):
        return output_size, output_size
    return tuple(output_size)


# ------------------------------------------------------------------ NMS


def _iou_matrix(boxes):
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    xx1 = np.maximum(x1[:, None], x1[None, :])
    yy1 = np.maximum(y1[:, None], y1[None, :])
    xx2 = np.minimum(x2[:, None], x2[None, :])
    yy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
    return inter / (area[:, None] + area[None, :] - inter + 1e-10)


def _nms_indices(b, iou_threshold, sc, cats, top_k):
    b = b.astype(np.float64)
    n = b.shape[0]
    sc = sc.astype(np.float64) if sc is not None else \
        np.arange(n, 0, -1, dtype=np.float64)
    cats = cats if cats is not None else np.zeros(n, np.int64)
    keep_all = []
    for c in np.unique(cats):
        idx = np.where(cats == c)[0]
        order = np.argsort(-sc[idx])
        iou = _iou_matrix(b[idx])          # the category's boxes only
        kept = []
        suppressed = np.zeros(idx.size, bool)
        for oi in order:
            if suppressed[oi]:
                continue
            kept.append(idx[oi])
            suppressed |= iou[oi] > iou_threshold
            suppressed[oi] = False
        keep_all.extend(kept)
    keep_all = sorted(keep_all, key=lambda i: -sc[i])
    if top_k is not None:
        keep_all = keep_all[:top_k]
    return np.asarray(keep_all, np.int64)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Hard NMS: the kept indices, by descending score; per category
    when ``category_idxs`` is given."""
    keep = _nms_indices(
        _np(boxes), iou_threshold,
        _np(scores) if scores is not None else None,
        _np(category_idxs) if category_idxs is not None else None, top_k)
    return _result(keep, boxes)


def matrix_nms(bboxes, scores, score_threshold, post_threshold,
               nms_top_k, keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS: each box's score decayed by its largest IoU with
    higher-scored boxes of its class. One image."""
    bb = _np(bboxes)
    sc = _np(scores)
    if bb.ndim == 3:
        bb = bb[0]
    if sc.ndim == 3:
        sc = sc[0]
    outs, idxs = [], []
    C = sc.shape[0]
    for c in range(C):
        if c == background_label:
            continue
        s = sc[c]
        sel = np.where(s > score_threshold)[0]
        if sel.size == 0:
            continue
        order = sel[np.argsort(-s[sel])][:nms_top_k]
        boxes_c = bb[order]
        iou = _iou_matrix(boxes_c)
        iou = np.triu(iou, 1)
        # max_iou[i]: box i's own largest overlap with higher-scored
        # boxes, the compensation term, indexed by the suppressor row i
        max_iou = iou.max(0, initial=0.0)
        if use_gaussian:
            decay = np.exp(-(iou ** 2 - max_iou[:, None] ** 2)
                           / gaussian_sigma).min(0, initial=1.0)
        else:
            decay = ((1 - iou) / (1 - max_iou[:, None] + 1e-10)
                     ).min(0, initial=1.0)
        new_s = s[order] * decay
        ok = new_s > post_threshold
        for i, o in enumerate(order):
            if ok[i]:
                outs.append([c, new_s[i], *bb[o]])
                idxs.append(o)
    outs = sorted(zip(outs, idxs), key=lambda t: -t[0][1])[:keep_top_k]
    det = np.asarray([o for o, _ in outs], np.float32).reshape(-1, 6)
    index = np.asarray([i for _, i in outs], np.int64)
    res = [_result(det, bboxes)]
    if return_index:
        res.append(_result(index, bboxes))
    if return_rois_num:
        res.append(_result(np.asarray([det.shape[0]], np.int32), bboxes))
    return tuple(res) if len(res) > 1 else res[0]


# ------------------------------------------------------------- RoI ops


def _roi_align_one(feat, roi, out_h, out_w, spatial_scale, s_y, s_x,
                   aligned):
    """``feat [C, H, W]``, ``roi [4]`` (x1, y1, x2, y2), ``s_y`` x
    ``s_x`` samples a bin."""
    off = 0.5 if aligned else 0.0
    x1 = roi[0] * spatial_scale - off
    y1 = roi[1] * spatial_scale - off
    x2 = roi[2] * spatial_scale - off
    y2 = roi[3] * spatial_scale - off
    # aligned=True permits degenerate rois; unaligned clamps to 1 px
    min_sz = 1e-3 if aligned else 1.0
    rw = _jmax(x2 - x1, min_sz)
    rh = _jmax(y2 - y1, min_sz)
    bin_h = rh / out_h
    bin_w = rw / out_w
    dev = feat.device
    ys = y1 + (torch.arange(out_h, device=dev)[:, None]
               + (torch.arange(s_y, device=dev)[None, :] + 0.5) / s_y
               ) * bin_h                          # [out_h, s_y]
    xs = x1 + (torch.arange(out_w, device=dev)[:, None]
               + (torch.arange(s_x, device=dev)[None, :] + 0.5) / s_x
               ) * bin_w                          # [out_w, s_x]
    H, W = feat.shape[-2], feat.shape[-1]

    def bilinear(y, x):
        y0 = torch.clamp(torch.floor(y), 0, H - 1)
        x0 = torch.clamp(torch.floor(x), 0, W - 1)
        y1_ = torch.clamp(y0 + 1, 0, H - 1)
        x1_ = torch.clamp(x0 + 1, 0, W - 1)
        wy = _jclip(y - y0, 0.0, 1.0)
        wx = _jclip(x - x0, 0.0, 1.0)
        iy0, ix0, iy1, ix1 = (t.long() for t in (y0, x0, y1_, x1_))
        v00 = feat[:, iy0][:, :, ix0]
        v01 = feat[:, iy0][:, :, ix1]
        v10 = feat[:, iy1][:, :, ix0]
        v11 = feat[:, iy1][:, :, ix1]
        return (v00 * ((1 - wy)[:, None] * (1 - wx)[None, :])
                + v01 * ((1 - wy)[:, None] * wx[None, :])
                + v10 * (wy[:, None] * (1 - wx)[None, :])
                + v11 * (wy[:, None] * wx[None, :]))

    vals = bilinear(ys.reshape(-1), xs.reshape(-1))
    C = vals.shape[0]
    vals = vals.reshape(C, out_h, s_y, out_w, s_x)
    return vals.mean((2, 4))


def _tracing():
    if torch.compiler.is_exporting() or torch.compiler.is_compiling():
        return True
    from ..static.graph import in_static_build
    return in_static_build()


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign: the bilinear samples of each bin averaged; a box at a
    time, as the reference. With ``sampling_ratio <= 0`` each box's grid
    is ``ceil(roi_h / out_h) x ceil(roi_w / out_w)``, computed on the
    host from the concrete boxes; under export tracing or a static build
    (boxes not concrete, or fed anew at each run) a fixed 2 x 2, as the
    reference falls back under a tracer or its recorder."""
    out_h, out_w = _size2(output_size)
    bn = _np(boxes_num).astype(np.int64)
    batch_of_roi = np.repeat(np.arange(bn.size), bn)
    if sampling_ratio > 0:
        grids = [(sampling_ratio, sampling_ratio)] * batch_of_roi.size
    elif _tracing():
        grids = [(2, 2)] * batch_of_roi.size
    else:
        bnp = _np(boxes).astype(np.float64).reshape(-1, 4)
        min_sz = 1e-3 if aligned else 1.0
        grids = []
        for i in range(bnp.shape[0]):
            rw = max((bnp[i, 2] - bnp[i, 0]) * spatial_scale, min_sz)
            rh = max((bnp[i, 3] - bnp[i, 1]) * spatial_scale, min_sz)
            grids.append((max(1, int(np.ceil(rh / out_h))),
                          max(1, int(np.ceil(rw / out_w)))))

    def fn(xv, bv):
        outs = []
        for i in range(bv.shape[0]):
            feat = xv[int(batch_of_roi[i])]
            s_y, s_x = grids[i]
            outs.append(_roi_align_one(feat, bv[i], out_h, out_w,
                                       spatial_scale, s_y, s_x, aligned))
        return torch.stack(outs) if outs else xv.new_zeros(
            (0, xv.shape[1], out_h, out_w))

    return dispatch(fn, x, boxes, name="roi_align")


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """RoI max pooling: each bin's exact masked max over the whole
    feature map (no cap on the window)."""
    out_h, out_w = _size2(output_size)
    bn = _np(boxes_num).astype(np.int64)
    batch_of_roi = np.repeat(np.arange(bn.size), bn)

    def fn(xv, bv):
        H, W = xv.shape[-2], xv.shape[-1]
        yidx = torch.arange(H, device=xv.device)[:, None]
        xidx = torch.arange(W, device=xv.device)[None, :]
        neg_inf = torch.tensor(-torch.inf, dtype=xv.dtype, device=xv.device)
        outs = []
        for i in range(bv.shape[0]):
            feat = xv[int(batch_of_roi[i])]
            x1 = torch.round(bv[i, 0] * spatial_scale)
            y1 = torch.round(bv[i, 1] * spatial_scale)
            x2 = torch.maximum(torch.round(bv[i, 2] * spatial_scale), x1 + 1)
            y2 = torch.maximum(torch.round(bv[i, 3] * spatial_scale), y1 + 1)
            bin_h = (y2 - y1) / out_h
            bin_w = (x2 - x1) / out_w
            rows = []
            for r in range(out_h):
                cols = []
                for c in range(out_w):
                    ys = torch.floor(y1 + r * bin_h)
                    ye = torch.ceil(y1 + (r + 1) * bin_h)
                    xs = torch.floor(x1 + c * bin_w)
                    xe = torch.ceil(x1 + (c + 1) * bin_w)
                    m = ((yidx >= ys) & (yidx < ye)
                         & (xidx >= xs) & (xidx < xe))
                    cols.append(torch.where(m[None], feat, neg_inf).amax(
                        dim=(1, 2)))
                rows.append(torch.stack(cols, -1))
            outs.append(torch.stack(rows, -2))
        return torch.stack(outs) if outs else xv.new_zeros(
            (0, xv.shape[1], out_h, out_w))

    return dispatch(fn, x, boxes, name="roi_pool")


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pooling: input channel ``(c *
    out_h + i) * out_w + j`` serves output channel ``c`` at bin ``(i,
    j)``."""
    out_h, out_w = _size2(output_size)
    aligned = roi_align(x, boxes, boxes_num, output_size, spatial_scale,
                        sampling_ratio=2, aligned=False)

    def fn(al):
        n, C, H, W = al.shape
        c_out = C // (out_h * out_w)
        al = al.reshape(n, c_out, out_h, out_w, H, W)
        rows = []
        for i in range(out_h):
            cols = [al[:, :, i, j, i, j] for j in range(out_w)]
            rows.append(torch.stack(cols, -1))      # [n, c_out, out_w]
        return torch.stack(rows, -2)                # [n, c_out, out_h, out_w]

    return dispatch(fn, aligned, name="psroi_pool")


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


# ------------------------------------------------------------- anchors


def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes ``[fh, fw, priors, 4]`` and their variances."""
    fh, fw = int(input.shape[-2]), int(input.shape[-1])
    ih, iw = int(image.shape[-2]), int(image.shape[-1])
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ars = list(aspect_ratios)
    if flip:
        ars = ars + [1.0 / a for a in aspect_ratios if a != 1.0]
    boxes = []
    for i in range(fh):
        for j in range(fw):
            cx = (j + offset) * step_w
            cy = (i + offset) * step_h
            cell = []
            for k, ms in enumerate(min_sizes):
                # the order: (min, aspect-ratio boxes, max); with
                # min_max_aspect_ratios_order: (min, max, aspect ratios)
                min_box = (cx, cy, ms, ms)
                max_box = None
                if max_sizes:
                    sz = (ms * max_sizes[k]) ** 0.5
                    max_box = (cx, cy, sz, sz)
                ar_boxes = [(cx, cy, ms * a ** 0.5, ms / a ** 0.5)
                            for a in ars if abs(a - 1.0) >= 1e-6]
                if min_max_aspect_ratios_order:
                    cell.append(min_box)
                    if max_box:
                        cell.append(max_box)
                    cell.extend(ar_boxes)
                else:
                    cell.append(min_box)
                    cell.extend(ar_boxes)
                    if max_box:
                        cell.append(max_box)
            for (ccx, ccy, bw, bh) in cell:
                boxes.append([(ccx - bw / 2) / iw, (ccy - bh / 2) / ih,
                              (ccx + bw / 2) / iw, (ccy + bh / 2) / ih])
    out = np.asarray(boxes, np.float32).reshape(fh, fw, -1, 4)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    return _result(out, input), _result(var, input)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode boxes against priors, or decode deltas."""
    pb = _np(prior_box).astype(np.float32)
    pv = _np(prior_box_var).astype(np.float32) if prior_box_var is not None \
        else np.ones_like(pb)
    tb = _np(target_box).astype(np.float32)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        out = np.stack([(tcx - pcx) / pw / pv[:, 0],
                        (tcy - pcy) / ph / pv[:, 1],
                        np.log(tw / pw) / pv[:, 2],
                        np.log(th / ph) / pv[:, 3]], -1)
    else:  # decode_center_size; tb [N, M, 4] or [N, 4]
        if tb.ndim == 2:
            tb = tb[:, None, :]

        def bc(v):
            # axis=0: prior i decodes row i; axis=1: prior j column j
            return v[:, None] if axis == 0 else v[None, :]

        dcx = bc(pv[:, 0]) * tb[..., 0] * bc(pw) + bc(pcx)
        dcy = bc(pv[:, 1]) * tb[..., 1] * bc(ph) + bc(pcy)
        dw = np.exp(bc(pv[:, 2]) * tb[..., 2]) * bc(pw)
        dh = np.exp(bc(pv[:, 3]) * tb[..., 3]) * bc(ph)
        out = np.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5 - norm, dcy + dh * 0.5 - norm], -1)
        out = out.squeeze(1) if out.shape[1] == 1 else out
    return _result(out.astype(np.float32), target_box)


# ------------------------------------------------------------- YOLO


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """A YOLOv3 head's outputs decoded to boxes and scores; both zero
    below ``conf_thresh``."""
    xv = _np(x).astype(np.float32)
    n, c, h, w = xv.shape
    na = len(anchors) // 2
    an = np.asarray(anchors, np.float32).reshape(na, 2)
    ioup = None
    if iou_aware:
        # [N, na * (6 + cls), H, W]: the first na channels are IoU logits
        ioup = xv[:, :na]
        xv = xv[:, na:]
    xv = xv.reshape(n, na, 5 + class_num, h, w)
    gx = np.arange(w, dtype=np.float32)[None, None, None, :]
    gy = np.arange(h, dtype=np.float32)[None, None, :, None]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    bx = (sig(xv[:, :, 0]) * scale_x_y - 0.5 * (scale_x_y - 1) + gx) / w
    by = (sig(xv[:, :, 1]) * scale_x_y - 0.5 * (scale_x_y - 1) + gy) / h
    in_w = downsample_ratio * w
    in_h = downsample_ratio * h
    bw = np.exp(xv[:, :, 2]) * an[None, :, 0, None, None] / in_w
    bh = np.exp(xv[:, :, 3]) * an[None, :, 1, None, None] / in_h
    conf = sig(xv[:, :, 4])
    if ioup is not None:
        conf = conf ** (1.0 - iou_aware_factor) \
            * sig(ioup) ** iou_aware_factor
    probs = sig(xv[:, :, 5:])
    scores = conf[:, :, None] * probs
    isz = _np(img_size).astype(np.float32)            # [N, 2] (h, w)
    imh = isz[:, 0].reshape(n, 1, 1, 1)
    imw = isz[:, 1].reshape(n, 1, 1, 1)
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        x1 = np.clip(x1, 0, imw - 1)
        y1 = np.clip(y1, 0, imh - 1)
        x2 = np.clip(x2, 0, imw - 1)
        y2 = np.clip(y2, 0, imh - 1)
    boxes = np.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
    keep = conf > conf_thresh
    boxes = boxes * keep.reshape(n, -1, 1)
    scores = scores * keep[:, :, None]
    scores = scores.transpose(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    return _result(boxes.astype(np.float32), x), \
        _result(scores.astype(np.float32), x)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """The YOLOv3 training loss in the reference's dense form: the
    centre's MSE and the class BCE at each cell holding a ground-truth
    centre, the objectness BCE everywhere."""
    n, c, h, w = x.shape
    na = len(anchor_mask)
    gtb = _np(gt_box)                                  # [N, B, 4] cx cy w h
    gtl = _np(gt_label).astype(np.int64)               # [N, B]
    obj_target = np.zeros((n, na, h, w), np.float32)
    coord_target = np.zeros((n, na, 4, h, w), np.float32)
    cls_target = np.zeros((n, na, class_num, h, w), np.float32)
    for b in range(n):
        for k in range(gtb.shape[1]):
            cx, cy, bw, bh = gtb[b, k]
            if bw <= 0 or bh <= 0:
                continue
            gi = min(int(cx * w), w - 1)
            gj = min(int(cy * h), h - 1)
            obj_target[b, :, gj, gi] = 1.0
            coord_target[b, :, 0, gj, gi] = cx * w - gi
            coord_target[b, :, 1, gj, gi] = cy * h - gj
            cls_target[b, :, gtl[b, k], gj, gi] = 1.0

    def fn(xv):
        xv = xv.reshape(n, na, 5 + class_num, h, w)
        pred_xy = torch.sigmoid(xv[:, :, 0:2])
        obj_logit = xv[:, :, 4]
        cls_logit = xv[:, :, 5:]
        obj_t = torch.as_tensor(obj_target, device=xv.device)
        coord_t = torch.as_tensor(coord_target[:, :, 0:2], device=xv.device)
        cls_t = torch.as_tensor(cls_target, device=xv.device)
        coord_loss = torch.sum(torch.square(pred_xy - coord_t)
                               * obj_t[:, :, None])

        def bce(lg, t):
            return _jmax(lg, 0.0) - lg * t + torch.log1p(
                torch.exp(-torch.abs(lg)))

        obj_loss = torch.sum(bce(obj_logit, obj_t))
        cls_loss = torch.sum(bce(cls_logit, cls_t) * obj_t[:, :, None])
        return (coord_loss + obj_loss + cls_loss) / n

    return dispatch(fn, x, name="yolo_loss")


# ---------------------------------------------------------- proposals


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Route RoIs to the FPN levels by their scale: the RoIs of each
    level, the index that restores the input order and, with
    ``rois_num``, each level's count."""
    rois = _np(fpn_rois).astype(np.float32)
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = np.sqrt(np.maximum(w * h, 1e-6))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, idxs = [], []
    for level in range(min_level, max_level + 1):
        sel = np.where(lvl == level)[0]
        outs.append(_result(rois[sel], fpn_rois))
        idxs.append(sel)
    restore = np.argsort(np.concatenate(idxs)) if idxs else np.array([])
    res_num = [_result(np.asarray([o.shape[0]], np.int32), fpn_rois)
               for o in outs] if rois_num is not None else None
    return outs, _result(restore.astype(np.int64).reshape(-1, 1),
                         fpn_rois), res_num


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposals of one image: anchors decoded by the deltas,
    clipped, the small ones dropped, then NMS."""
    # scores [A, H, W] -> (H, W, A)-major to pair with deltas and anchors
    sc = _np(scores)[0].transpose(1, 2, 0).reshape(-1)
    deltas = _np(bbox_deltas)[0].transpose(1, 2, 0).reshape(-1, 4)
    an = _np(anchors).reshape(-1, 4)
    var = _np(variances).reshape(-1, 4)
    ih, iw = [float(v) for v in _np(img_size)[0][:2]]
    aw = an[:, 2] - an[:, 0]
    ah = an[:, 3] - an[:, 1]
    acx = an[:, 0] + aw / 2
    acy = an[:, 1] + ah / 2
    dcx = var[:, 0] * deltas[:, 0] * aw + acx
    dcy = var[:, 1] * deltas[:, 1] * ah + acy
    dw = np.exp(np.minimum(var[:, 2] * deltas[:, 2], 10)) * aw
    dh = np.exp(np.minimum(var[:, 3] * deltas[:, 3], 10)) * ah
    boxes = np.stack([dcx - dw / 2, dcy - dh / 2,
                      dcx + dw / 2, dcy + dh / 2], -1)
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih)
    keep = np.where((boxes[:, 2] - boxes[:, 0] >= min_size)
                    & (boxes[:, 3] - boxes[:, 1] >= min_size))[0]
    order = keep[np.argsort(-sc[keep])][:pre_nms_top_n]
    # float32 into the NMS, as the reference's tensors carry them there
    kept = _nms_indices(boxes[order].astype(np.float32), nms_thresh,
                        sc[order].astype(np.float32), None,
                        None)[:post_nms_top_n]
    sel = order[kept]
    rois = _result(boxes[sel].astype(np.float32), scores)
    rscores = _result(sc[sel].astype(np.float32), scores)
    if return_rois_num:
        return rois, rscores, _result(np.asarray([sel.size], np.int32),
                                      scores)
    return rois, rscores


# ------------------------------------------------------------- image IO


def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor on the default place."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    return _result(data)


def decode_jpeg(x, mode="unchanged", name=None):
    """A JPEG's bytes (a uint8 tensor) decoded by PIL into ``[C, H, W]``
    uint8, on the bytes' device."""
    from PIL import Image
    raw = _np(x).astype(np.uint8).tobytes()
    img = Image.open(_io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    # "unchanged": the file's own channel count
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return _result(np.ascontiguousarray(arr), x)


# -------------------------------------------------------- deform conv


def _first(v):
    return v if isinstance(v, int) else v[0]


def _deform_conv2d(x, offset, weight, bias, mask, stride, padding,
                   dilation, deformable_groups, groups):
    kh, kw = weight.shape[-2], weight.shape[-1]
    b, c, h, w = x.shape
    st, pd, dl = _first(stride), _first(padding), _first(dilation)
    oh = (h + 2 * pd - dl * (kh - 1) - 1) // st + 1
    ow = (w + 2 * pd - dl * (kw - 1) - 1) // st + 1
    base_y = np.arange(oh) * st - pd
    base_x = np.arange(ow) * st - pd
    K = kh * kw
    dg = deformable_groups
    cg = c // dg                      # input channels a deformable group
    out = None
    k = 0
    for i in range(kh):
        for j in range(kw):
            # deformable group g owns taps [g*2K : (g+1)*2K] of the
            # offsets and warps channels [g*cg : (g+1)*cg]
            parts = []
            for g in range(dg):
                dy = offset[:, 2 * (g * K + k)]
                dx = offset[:, 2 * (g * K + k) + 1]
                gy = torch.as_tensor(np.broadcast_to(
                    base_y[:, None] + i * dl, (oh, ow)).astype(np.float32),
                    device=x.device) + dy
                gx = torch.as_tensor(np.broadcast_to(
                    base_x[None, :] + j * dl, (oh, ow)).astype(np.float32),
                    device=x.device) + dx
                gxn = gx * (2.0 / max(w - 1, 1)) - 1.0
                gyn = gy * (2.0 / max(h - 1, 1)) - 1.0
                grid = torch.stack([gxn, gyn], -1)
                xs = x[:, g * cg:(g + 1) * cg] if dg > 1 else x
                sp = F.grid_sample(xs, grid, align_corners=True)
                if mask is not None:
                    sp = sp * mask[:, g * K + k:g * K + k + 1]
                parts.append(sp)
            samp = parts[0] if dg == 1 else torch.cat(parts, 1)
            contrib = F.conv2d(samp, weight[:, :, i:i + 1, j:j + 1],
                               groups=groups)
            out = contrib if out is None else out + contrib
            k += 1
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (v2 with ``mask``): each tap's input
    sampled at its offset positions by ``grid_sample`` and weighted by a
    1 x 1 convolution, the taps summed."""
    return dispatch(
        lambda xv, ov, wv, bv, mv: _deform_conv2d(
            xv, ov, wv, bv, mv, stride, padding, dilation,
            deformable_groups, groups),
        x, offset, weight, bias, mask, name="deform_conv2d")


class DeformConv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        from ..nn.initializer import XavierNormal
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + ks, attr=weight_attr,
            default_initializer=XavierNormal())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter((out_channels,),
                                              attr=bias_attr, is_bias=True)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.deformable_groups = deformable_groups
        self.groups = groups

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             self.stride, self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)

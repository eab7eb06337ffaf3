"""``paddle.static.nn``: the layer functions of static programs.

Port of ``paddle_tpu/static/nn.py``. ``fc``, ``embedding``, ``conv2d``,
``batch_norm`` and ``layer_norm`` make their parameters with
``static.create_parameter`` (the fill op in the startup program) and
record their op into the default main program; the rest build an eager
``nn`` layer and call it, which ``program_guard`` records as one op over
the layer's parameters. ``dropout`` is the functional one: on the card,
R2 under the Executor's per-run keys. The control flow (``cond``,
``while_loop``) goes through ``jit.dy2static``'s converters; ``case``
and ``switch_case`` read concrete predicates.
"""
import numpy as np

from ..core.tensor import Tensor, wrap


def _F():
    from ..nn import functional
    return functional


def _pt():
    import paddle_tpu_torch
    return paddle_tpu_torch


def _dt(x):
    return str(x._value.dtype).replace("torch.", "")


def _param(*args, **kwargs):
    """``paddle.create_parameter`` as a paddle Tensor over the leaf."""
    return wrap(_pt().create_parameter(*args, **kwargs))


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    from . import create_parameter
    from ..nn import initializer as I
    in_dim = int(np.prod(x._value.shape[num_flatten_dims:]))
    w = create_parameter([in_dim, size], _dt(x),
                         default_initializer=weight_attr)
    b = None
    if bias_attr is not False:
        b = create_parameter([size], _dt(x), is_bias=True,
                             default_initializer=bias_attr or I.Constant(0.0))
    F = _F()
    if len(x._value.shape) > num_flatten_dims + 1:
        lead = list(x._value.shape[:num_flatten_dims])
        x = _pt().reshape(x, lead + [in_dim])
    out = F.linear(x, w, b)
    if activation:
        out = getattr(F, activation)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    from . import create_parameter
    from ..nn import initializer as I
    w = create_parameter(list(size), dtype,
                         default_initializer=param_attr or I.Normal(0, 0.02))
    return _F().embedding(input, w, padding_idx=padding_idx)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, data_format="NCHW"):
    from . import create_parameter
    from ..nn import initializer as I
    ks = ([filter_size, filter_size] if isinstance(filter_size, int)
          else list(filter_size))
    in_ch = (input._value.shape[1] if data_format == "NCHW"
             else input._value.shape[-1])
    w = create_parameter([num_filters, in_ch // groups] + ks,
                         _dt(input),
                         default_initializer=param_attr or I.KaimingUniform())
    b = None
    if bias_attr is not False:
        b = create_parameter([num_filters], _dt(input),
                             is_bias=True,
                             default_initializer=bias_attr or I.Constant(0.0))
    return _F().conv2d(input, w, b, stride=stride, padding=padding,
                       dilation=dilation, groups=groups,
                       data_format=data_format)


def batch_norm(input, momentum=0.9, epsilon=1e-5, param_attr=None,
               bias_attr=None, data_format="NCHW", is_test=False):
    """Static BN: runs with the running statistics (persistable
    variables), as an inference program does."""
    from . import create_parameter, create_global_var
    from ..nn import initializer as I
    ch = (input._value.shape[1] if data_format in ("NCHW", "NCL")
          else input._value.shape[-1])
    dt = _dt(input)
    scale = create_parameter([ch], dt,
                             default_initializer=param_attr or I.Constant(1.0))
    bias = create_parameter([ch], dt, is_bias=True,
                            default_initializer=bias_attr or I.Constant(0.0))
    mean = create_global_var([ch], 0.0, dt, name=None)
    var = create_global_var([ch], 1.0, dt, name=None)
    return _F().batch_norm(input, mean, var, scale, bias, training=False,
                           momentum=momentum, epsilon=epsilon,
                           data_format=data_format)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None):
    from . import create_parameter
    from ..nn import initializer as I
    shape = [int(d) for d in input._value.shape[begin_norm_axis:]]
    dt = _dt(input)
    w = create_parameter(shape, dt,
                         default_initializer=param_attr or I.Constant(1.0)) \
        if scale else None
    b = create_parameter(shape, dt, is_bias=True,
                         default_initializer=bias_attr or I.Constant(0.0)) \
        if shift else None
    return _F().layer_norm(input, normalized_shape=shape, weight=w, bias=b,
                           epsilon=epsilon)


def dropout(x, dropout_prob=0.5, is_test=False):
    return _F().dropout(x, p=dropout_prob, training=not is_test)


# ----------------------------------------------- round-3 static.nn tail
# (reference python/paddle/static/nn/__init__.py __all__)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, data_format="NCDHW", name=None):
    from .nn_shim import apply_act
    from ..nn import Conv3D
    layer = Conv3D(input.shape[1], num_filters, filter_size, stride=stride,
                   padding=padding, dilation=dilation, groups=groups,
                   weight_attr=param_attr, bias_attr=bias_attr)
    return apply_act(layer(input), act)


def conv2d_transpose(input, num_filters, filter_size, stride=1,  # noqa: A002
                     padding=0, output_padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     output_size=None, data_format="NCHW", name=None):
    from .nn_shim import apply_act
    from ..nn import Conv2DTranspose
    layer = Conv2DTranspose(input.shape[1], num_filters, filter_size,
                            stride=stride, padding=padding,
                            output_padding=output_padding,
                            dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr)
    return apply_act(layer(input), act)


def conv3d_transpose(input, num_filters, filter_size, stride=1,  # noqa: A002
                     padding=0, output_padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     output_size=None, data_format="NCDHW", name=None):
    from .nn_shim import apply_act
    from ..nn import Conv3DTranspose
    layer = Conv3DTranspose(input.shape[1], num_filters, filter_size,
                            stride=stride, padding=padding,
                            output_padding=output_padding,
                            dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr)
    return apply_act(layer(input), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,  # noqa: A002
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from .nn_shim import apply_act
    from ..nn import GroupNorm
    layer = GroupNorm(groups, input.shape[1], epsilon=epsilon,
                      weight_attr=param_attr, bias_attr=bias_attr)
    return apply_act(layer(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None,  # noqa: A002
                  bias_attr=None, name=None):
    from ..nn import InstanceNorm2D
    layer = InstanceNorm2D(input.shape[1], epsilon=epsilon,
                           weight_attr=param_attr, bias_attr=bias_attr)
    return layer(input)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,  # noqa: A002
              enable_scale_and_shift=False, name=None, **kwargs):
    """Reference static.nn.data_norm: normalize by running batch stats
    without learned affine (unless enabled)."""
    from ..nn import functional as F
    from .nn_shim import apply_act
    mean = input.mean(axis=0, keepdim=True)
    var = ((input - mean) ** 2).mean(axis=0, keepdim=True)
    out = (input - mean) / (var + epsilon) ** 0.5
    return apply_act(out, act)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    from ..nn import PReLU
    n = 1 if mode == "all" else x.shape[1]
    return PReLU(num_parameters=n, weight_attr=param_attr)(x)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from ..nn import SpectralNorm
    layer = SpectralNorm(weight.shape, dim=dim, power_iters=power_iters,
                         eps=eps)
    return layer(weight)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    from ..nn import Bilinear
    from .nn_shim import apply_act
    layer = Bilinear(x.shape[-1], y.shape[-1], size,
                     weight_attr=param_attr, bias_attr=bias_attr)
    return apply_act(layer(x, y), act)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None,
                  name=None):
    return _deform_conv2d_impl(
        x, offset, mask, num_filters, filter_size, stride, padding,
        dilation, groups, deformable_groups, param_attr, bias_attr)


def _deform_conv2d_impl(x, offset, mask, num_filters, filter_size, stride,
                        padding, dilation, groups, deformable_groups,
                        param_attr, bias_attr):
    """Deformable conv v2 as ``grid_sample`` and a dense conv: each
    kernel tap samples the input at its offsets (weighted by ``mask``),
    then the conv's weights apply tap by tap."""
    pt = _pt()
    from ..nn import Conv2D
    from ..nn import functional as F
    kh = kw = filter_size if isinstance(filter_size, int) else None
    if kh is None:
        kh, kw = filter_size
    b, c, h, w = x.shape
    layer = Conv2D(c, num_filters, (kh, kw), stride=stride, padding=padding,
                   dilation=dilation, groups=groups,
                   weight_attr=param_attr, bias_attr=bias_attr)
    # sample each kernel tap position with its offset via grid_sample,
    # then weight by mask and run 1x1-equivalent accumulation through
    # the conv weights: compose as unfold-with-offsets
    oh = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    ow = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    base_y = np.arange(oh) * stride - padding
    base_x = np.arange(ow) * stride - padding
    cols = []
    k = 0
    for i in range(kh):
        for j in range(kw):
            # offset channels: [B, 2*K, oh, ow] ordered (y, x) per tap
            dy = offset[:, 2 * k]
            dx = offset[:, 2 * k + 1]
            gy = pt.to_tensor(
                np.broadcast_to(base_y[:, None] + i * dilation,
                                (oh, ow)).astype("float32")) + dy
            gx = pt.to_tensor(
                np.broadcast_to(base_x[None, :] + j * dilation,
                                (oh, ow)).astype("float32")) + dx
            # normalize to [-1, 1] for grid_sample
            gxn = gx * (2.0 / max(w - 1, 1)) - 1.0
            gyn = gy * (2.0 / max(h - 1, 1)) - 1.0
            grid = pt.stack([gxn, gyn], axis=-1)
            samp = F.grid_sample(x, grid, align_corners=True)
            if mask is not None:
                samp = samp * mask[:, k:k + 1]
            cols.append(samp)
            k += 1
    # cols: K tensors [B, C, oh, ow] -> conv weight [F, C, kh, kw] applies
    # as sum_k W[:, :, k] . cols[k]
    wgt = wrap(layer.weight)  # [F, C/groups, kh, kw]
    out = None
    k = 0
    for i in range(kh):
        for j in range(kw):
            contrib = F.conv2d(cols[k], wgt[:, :, i:i + 1, j:j + 1])
            out = contrib if out is None else out + contrib
            k += 1
    if layer.bias is not None:
        out = out + wrap(layer.bias).reshape([1, -1, 1, 1])
    return out


def nce(input, label, num_total_classes, sample_weight=None,  # noqa: A002
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference static.nn.nce):
    logistic discrimination of the true class against sampled noise."""
    pt = _pt()
    from ..nn import functional as F
    d = input.shape[-1]
    w = _param([num_total_classes, d], attr=param_attr)
    bvec = _param([num_total_classes], attr=bias_attr, is_bias=True)
    lb = label.reshape([-1])
    pos_logit = (input * w[lb]).sum(axis=-1) + bvec[lb]
    neg_idx = pt.to_tensor(np.random.randint(
        0, num_total_classes, (num_neg_samples,)).astype("int64"))
    neg_logit = input @ w[neg_idx].T + bvec[neg_idx]
    pos_loss = F.binary_cross_entropy_with_logits(
        pos_logit, pt.ones_like(pos_logit))
    neg_loss = F.binary_cross_entropy_with_logits(
        neg_logit, pt.zeros_like(neg_logit))
    # undo BCE's mean over the negatives: NCE sums over noise samples
    return pos_loss + neg_loss * num_neg_samples


def row_conv(input, future_context_size, param_attr=None, act=None):  # noqa: A002
    """Lookahead row convolution (reference static.nn.row_conv): each time
    step mixes the next `future_context_size` steps per feature."""
    pt = _pt()
    from .nn_shim import apply_act
    d = input.shape[-1]
    k = future_context_size + 1
    w = _param([k, d], attr=param_attr)
    x = input
    acc = None
    for i in range(k):
        if input.ndim == 3:
            shifted = pt.concat(
                [x[:, i:], pt.zeros_like(x[:, :i])], axis=1) if i else x
            term = shifted * w[i]
        else:
            shifted = pt.concat(
                [x[i:], pt.zeros_like(x[:i])], axis=0) if i else x
            term = shifted * w[i]
        acc = term if acc is None else acc + term
    return apply_act(acc, act)


def sparse_embedding(input, size, padding_idx=None, is_test=False,  # noqa: A002
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32", slot=None):
    """The parameter server's sparse-table embedding
    (``static.nn.sparse_embedding``), in one process: a dense embedding
    with the same semantics."""
    from ..nn import Embedding
    layer = Embedding(size[0], size[1], padding_idx=padding_idx,
                      weight_attr=param_attr)
    return layer(input)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,  # noqa: A002
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None):
    """1-D sequence convolution over padded ``[B, T, D]`` batches (the
    LoD sequence ops as dense convolutions)."""
    from ..nn import Conv1D
    from .nn_shim import apply_act
    x = input.transpose([0, 2, 1])       # [B, D, T]
    layer = Conv1D(x.shape[1], num_filters, filter_size,
                   stride=filter_stride,
                   padding=(filter_size - 1) // 2 if padding else 0,
                   weight_attr=param_attr, bias_attr=bias_attr)
    return apply_act(layer(x).transpose([0, 2, 1]), act)


def sequence_softmax(input, use_cudnn=False, name=None):  # noqa: A002
    from ..nn import functional as F
    return F.softmax(input, axis=-1)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """``static.nn.py_func``: the host function applied to ``x``."""
    if isinstance(x, (list, tuple)):
        res = func(*x)
    else:
        res = func(x)
    return res


# control flow (reference static/nn/control_flow.py) -------------------


def cond(pred, true_fn=None, false_fn=None, name=None):
    from ..jit.dy2static import convert_ifelse
    return convert_ifelse(pred, true_fn or (lambda: None),
                          false_fn or (lambda: None), ())


def case(pred_fn_pairs, default=None, name=None):
    for pred, fn in pred_fn_pairs:
        p = bool(np.asarray(pred.numpy() if isinstance(pred, Tensor)
                            else pred))
        if p:
            return fn()
    return default() if default is not None else None


def switch_case(branch_index, branch_fns, default=None, name=None):
    idx = int(np.asarray(branch_index.numpy()
                         if isinstance(branch_index, Tensor)
                         else branch_index))
    fns = dict(branch_fns) if not isinstance(branch_fns, dict) else branch_fns
    fn = fns.get(idx, default)
    return fn() if fn is not None else None


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    from ..jit.dy2static import convert_while_loop
    return convert_while_loop(cond, body, tuple(loop_vars))


# --------------------------------------------------- legacy sequence ops
# (the reference's sequence_* LoD ops on dense padded [B, T, ...] batches
# with optional length vectors)


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):  # noqa: A002
    pool_type = pool_type.lower()
    if pool_type == "sum":
        return input.sum(axis=1)
    if pool_type in ("average", "mean", "avg"):
        return input.mean(axis=1)
    if pool_type == "sqrt":
        t = input.shape[1]
        return input.sum(axis=1) * (1.0 / (t ** 0.5))
    if pool_type == "max":
        return input.max(axis=1)
    if pool_type == "last":
        return input[:, -1]
    if pool_type == "first":
        return input[:, 0]
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_concat(input, name=None):  # noqa: A002
    return _pt().concat(list(input), axis=1)


def sequence_first_step(input):  # noqa: A002
    return input[:, 0]


def sequence_last_step(input):  # noqa: A002
    return input[:, -1]


def sequence_slice(input, offset, length, name=None):  # noqa: A002
    pt = _pt()
    off = np.asarray(offset.numpy() if isinstance(offset, Tensor)
                     else offset).reshape(-1)
    ln = np.asarray(length.numpy() if isinstance(length, Tensor)
                    else length).reshape(-1)
    rows = [input[b, int(off[b]):int(off[b]) + int(ln[b])]
            for b in range(input.shape[0])]
    # pad to the max kept length for a dense result
    m = max(int(v) for v in ln)
    padded = []
    for r in rows:
        if r.shape[0] < m:
            pad = pt.zeros([m - r.shape[0]] + list(r.shape[1:]),
                           dtype=r.dtype)
            r = pt.concat([r, pad], axis=0)
        padded.append(r)
    return pt.stack(padded, axis=0)


def sequence_expand(x, y, ref_level=-1, name=None):
    reps = y.shape[1] if y.ndim > 1 else 1
    return _pt().repeat_interleave(x, reps, axis=0)


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """x already dense [B, T, ...]: returns (x, lengths)."""
    lengths = _pt().to_tensor(np.full((x.shape[0],), x.shape[1], np.int64))
    return x, lengths


def sequence_unpad(x, length, name=None):
    ln = np.asarray(length.numpy() if isinstance(length, Tensor)
                    else length).reshape(-1)
    m = int(ln.max()) if ln.size else 0
    return x[:, :m]


def sequence_reshape(input, new_dim):  # noqa: A002
    b = input.shape[0]
    return input.reshape([b, -1, new_dim])


def sequence_scatter(input, index, updates, name=None):  # noqa: A002
    return _pt().put_along_axis(input, index, updates, 1, reduce="add")


def sequence_enumerate(input, win_size, pad_value=0, name=None):  # noqa: A002
    """Sliding windows of ids: [B, T] -> [B, T, win_size]."""
    pt = _pt()
    cols = []
    for i in range(win_size):
        if i == 0:
            cols.append(input)
        else:
            pad = pt.full(list(input.shape[:-1]) + [i], pad_value,
                          dtype=input.dtype)
            cols.append(pt.concat([input[..., i:], pad], axis=-1))
    return pt.stack(cols, axis=-1)


def sequence_reverse(x, name=None):
    return _pt().flip(x, axis=[1])


class StaticRNN:
    """The fluid-era StaticRNN builder, whose step body is captured into
    a sub-block: superseded, as in the reference, by ``nn.SimpleRNN`` /
    ``nn.LSTM`` / ``nn.GRU``. It can be made; ``step()`` raises saying
    so."""

    def __init__(self, name=None):
        self.name = name

    def step(self):
        raise NotImplementedError(
            "StaticRNN's sub-block step capture is a fluid-era protocol; "
            "use paddle_tpu_torch.nn.{SimpleRNN,LSTM,GRU}")

    step_input = memory = update_memory = step_output = output = step

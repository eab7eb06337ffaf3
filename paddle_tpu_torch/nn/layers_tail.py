"""The tail of ``nn``'s layers: port of ``paddle_tpu/nn/layers_tail.py``
(fold / unfold, pairwise distance, ``Softmax2D``, ``Silu``, the CTC,
RNN-T and hierarchical-sigmoid losses, pixel unshuffle, channel
shuffle, ``ZeroPad2D``, unpooling, the margin losses, 3-D adaptive max
pooling) and seq2seq decoding (``BeamSearchDecoder``, ``dynamic_decode``)
over the recurrent cells of ``rnn``.

Each layer holds its options and calls its op of ``nn.functional``;
``HSigmoidLoss`` draws its ``[num_classes - 1, feature_size]`` weight
(Xavier-normal) and its bias (zeros) from the global key, as the
reference does. ``dynamic_decode`` runs the reference's beam search on
the host (numpy between the cell's steps): decoding loops are data
dependent.
"""
import numpy as np
import torch

from ..core.tensor import Tensor
from . import functional as F
from .layer import Layer

__all__ = ["Unfold", "Fold", "PairwiseDistance", "Softmax2D", "Silu",
           "CTCLoss", "RNNTLoss", "HSigmoidLoss", "PixelUnshuffle",
           "ChannelShuffle", "ZeroPad2D", "MaxUnPool1D", "MaxUnPool2D",
           "MaxUnPool3D", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
           "TripletMarginWithDistanceLoss", "SoftMarginLoss",
           "AdaptiveMaxPool3D", "BeamSearchDecoder", "dynamic_decode"]


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes,
                      self.strides, self.paddings, self.dilations)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Softmax2D(Layer):
    """Softmax over the channel axis of an NCHW input."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class Silu(Layer):
    def forward(self, x):
        return F.silu(x)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        return F.channel_shuffle(x, self.groups)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return F.zeropad2d(x, self.padding, self.data_format)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.output_size)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.output_size)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):  # noqa: A002
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           self.blank, self.fastemit_lambda, self.reduction)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size), attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter((num_classes - 1, 1),
                                              attr=bias_attr, is_bias=True)

    def forward(self, input, label):  # noqa: A002
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p = p
        self.margin = margin
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.soft_margin_loss(input, label, self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin = margin
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


# ------------------------------------------------------ seq2seq decoding


class BeamSearchDecoder:
    """Beam search over an RNN cell: ``cell(inputs, states) -> (output,
    new_states)``; ``embedding_fn`` maps token ids to the cell's inputs
    and ``output_fn`` the cell's output to vocabulary logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _logits(self, ids, states):
        from .. import to_tensor
        ids = to_tensor(ids)
        emb = self.embedding_fn(ids) if self.embedding_fn is not None \
            else ids
        out, new_states = self.cell(emb, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        return out, new_states


def _host(v):
    if isinstance(v, Tensor):
        v = v._value
    if torch.is_tensor(v):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """Beam-search decode loop (greedy at ``beam_size`` 1). Returns
    (ids ``[B, beam, T]``, sequence lengths ``[B, beam]``): beams ranked by
    their summed log-probability, a finished beam extended only by the
    end token at no cost, the histories traced back by parent."""
    from .. import to_tensor

    cell_states = decoder.cell.get_initial_states(inits) if hasattr(
        decoder.cell, "get_initial_states") and inits is None else inits
    B = int(_host(cell_states[0] if isinstance(cell_states, (list, tuple))
                  else cell_states).shape[0])
    K = decoder.beam_size

    def expand(s):                    # [B, ...] -> [B * K, ...]
        return to_tensor(np.repeat(_host(s), K, axis=0))

    states = [expand(s) for s in cell_states] if isinstance(
        cell_states, (list, tuple)) else expand(cell_states)
    ids = np.full((B * K,), decoder.start_token, np.int64)
    scores = np.full((B, K), -1e9, np.float32)
    scores[:, 0] = 0.0                # one live hypothesis at first
    finished = np.zeros((B, K), bool)
    lengths = np.zeros((B, K), np.int64)
    history = []

    for _t in range(max_step_num):
        logits, states = decoder._logits(ids, states)
        logp = _host(F.log_softmax(logits, axis=-1))
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V)
        fin_mask = np.full((V,), -1e9, np.float32)
        fin_mask[decoder.end_token] = 0.0
        logp = np.where(finished[..., None], fin_mask[None, None], logp)
        flat = (scores[..., None] + logp).reshape(B, K * V)
        top = np.argsort(-flat, axis=-1)[:, :K]
        scores = np.take_along_axis(flat, top, -1)
        beam_parent = top // V
        tok = top % V
        finished = np.take_along_axis(finished, beam_parent, -1) | (
            tok == decoder.end_token)
        lengths = np.take_along_axis(lengths, beam_parent, -1) + (
            ~finished).astype(np.int64)
        history.append((tok.copy(), beam_parent.copy()))
        gather = (np.arange(B)[:, None] * K + beam_parent).reshape(-1)

        def reorder(s):
            return to_tensor(_host(s)[gather])

        states = [reorder(s) for s in states] if isinstance(
            states, (list, tuple)) else reorder(states)
        ids = tok.reshape(-1).astype(np.int64)
        if finished.all():
            break

    T = len(history)
    out = np.zeros((B, K, T), np.int64)
    beam_idx = np.tile(np.arange(K), (B, 1))
    for t in range(T - 1, -1, -1):
        tok, parent = history[t]
        out[:, :, t] = np.take_along_axis(tok, beam_idx, -1)
        beam_idx = np.take_along_axis(parent, beam_idx, -1)
    return to_tensor(out), to_tensor(lengths)

"""Recurrent layers: port of ``paddle_tpu/nn/rnn.py`` (SimpleRNN, LSTM
and GRU cells, ``RNN`` / ``BiRNN``, the stacked ``SimpleRNN`` / ``LSTM``
/ ``GRU``).

The cells' formulas, gate orders (LSTM i, f, g, o; GRU r, z, c) and
parameter names and layouts are the reference's (``weight_ih [gates *
hidden, input]``, ``weight_hh``, ``bias_ih``, ``bias_hh``; a stack's
cells are the sublayers ``cell_l{i}`` and ``cell_l{i}_reverse``), so
state dicts cross unchanged. The scan over time is a Python loop of
plain torch ops (the reference's ``lax.scan``): the input projection of
every step is one matmul before the loop, the recurrent one a matmul a
step. cuDNN's RNN is not used: its gate order and rounding are not the
reference's. Past a row's ``sequence_length`` its state is kept and its
output is zero.
"""
import math

import torch

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
]


def _std_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


class RNNCellBase(Layer):
    """A single-step recurrent cell."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dt = dtype or torch.float32
        dev = batch_ref.device
        if isinstance(shape, (list, tuple)) and shape and \
                isinstance(shape[0], (list, tuple)):
            return tuple(torch.full((batch,) + tuple(s), init_value,
                                    dtype=dt, device=dev) for s in shape)
        return torch.full((batch,) + tuple(shape), init_value, dtype=dt,
                          device=dev)

    def _make_weights(self, gates, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr):
        init = _std_init(hidden_size)
        self.weight_ih = self.create_parameter(
            (gates * hidden_size, input_size), attr=weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            (gates * hidden_size, hidden_size), attr=weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            (gates * hidden_size,), attr=bias_ih_attr,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            (gates * hidden_size,), attr=bias_hh_attr,
            default_initializer=init)

    def _input_proj(self, x):
        """``x W_ih^T + b_ih`` (any leading axes)."""
        return torch.matmul(x, self.weight_ih.T) + self.bias_ih

    def _step(self, xp, *states):
        raise NotImplementedError


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self._make_weights(1, input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _num_states(self):
        return 1

    def _step(self, xp, h):
        g = xp + torch.matmul(h, self.weight_hh.T) + self.bias_hh
        h2 = torch.tanh(g) if self.activation == "tanh" else torch.relu(g)
        return h2, (h2,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = self._step(self._input_proj(inputs), states)[0]
        return out, out


class LSTMCell(RNNCellBase):
    """Gates i, f, g, o: ``c' = f c + i tanh(g)``, ``h' = o tanh(c')``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._make_weights(4, input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def _num_states(self):
        return 2

    def _step(self, xp, h, c):
        gates = xp + torch.matmul(h, self.weight_hh.T) + self.bias_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c2 = f * c + i * torch.tanh(g)
        h2 = o * torch.tanh(c2)
        return h2, (h2, c2)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        h2, c2 = self._step(self._input_proj(inputs), h, c)[1]
        return h2, (h2, c2)


class GRUCell(RNNCellBase):
    """Gates r, z, c: ``h' = z h + (1 - z) c``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._make_weights(3, input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _num_states(self):
        return 1

    def _step(self, xp, h):
        hg = torch.matmul(h, self.weight_hh.T) + self.bias_hh
        x_r, x_z, x_c = torch.chunk(xp, 3, dim=-1)
        h_r, h_z, h_c = torch.chunk(hg, 3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        c = torch.tanh(x_c + r * h_c)
        h2 = z * h + (1.0 - z) * c
        return h2, (h2,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = self._step(self._input_proj(inputs), states)[0]
        return out, out


def _scan_layer(cell, inputs, init_states, sequence_length=None,
                reverse=False, time_major=False):
    """One cell over time (``rnn.py:_scan_layer`` of the reference):
    returns (outputs, final states). Positions past ``sequence_length``
    keep their state and emit zeros."""
    xt = inputs if time_major else inputs.transpose(0, 1)     # [T, B, C]
    xp = cell._input_proj(xt)
    steps = range(xt.shape[0] - 1, -1, -1) if reverse else \
        range(xt.shape[0])
    states = tuple(init_states)
    outs = [None] * xt.shape[0]
    for t in steps:
        out, new = cell._step(xp[t], *states)
        if sequence_length is not None:
            keep = (t < sequence_length)[:, None]
            new = tuple(torch.where(keep, n, o) for n, o in zip(new, states))
            out = torch.where(keep, out, torch.zeros_like(out))
        states = new
        outs[t] = out
    outs = torch.stack(outs, 0)
    if not time_major:
        outs = outs.transpose(0, 1)
    return outs, states


class RNN(Layer):
    """A cell over a whole sequence."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        states = initial_states if isinstance(initial_states,
                                              (tuple, list)) \
            else (initial_states,)
        outs, final = _scan_layer(self.cell, inputs, tuple(states),
                                  sequence_length, self.is_reverse,
                                  self.time_major)
        return outs, (final if self.cell._num_states() > 1 else final[0])


class BiRNN(Layer):
    """A forward and a backward cell, their outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, fin_fw = self.rnn_fw(inputs, st_fw, sequence_length)
        out_bw, fin_bw = self.rnn_bw(inputs, st_bw, sequence_length)
        return torch.cat([out_fw, out_bw], -1), (fin_fw, fin_bw)


class _RNNBase(Layer):
    """A stack of layers, one or two directions each; states ``[layers *
    directions, batch, hidden]``; dropout between layers while
    training."""

    CELL = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **cell_kwargs):
        super().__init__()
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(f"bad direction {direction}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self._cells = []
        for layer_i in range(num_layers):
            in_sz = input_size if layer_i == 0 \
                else hidden_size * self.num_directions
            for d in range(self.num_directions):
                cell = self.CELL(in_sz, hidden_size, **cell_kwargs)
                suffix = f"l{layer_i}" + ("_reverse" if d else "")
                self.add_sublayer(f"cell_{suffix}", cell)
                self._cells.append(cell)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        n_state = self._cells[0]._num_states()
        L, D = self.num_layers, self.num_directions
        if initial_states is None:
            init_per = [None] * (L * D)
        else:
            sts = tuple(initial_states) if isinstance(
                initial_states, (tuple, list)) else (initial_states,)
            init_per = [tuple(s[i] for s in sts) for i in range(L * D)]
        x = inputs
        finals = []
        for layer_i in range(L):
            outs_dir = []
            for d in range(D):
                cell = self._cells[layer_i * D + d]
                st = init_per[layer_i * D + d]
                if st is None:
                    st = cell.get_initial_states(
                        x, batch_dim_idx=1 if self.time_major else 0)
                    st = st if isinstance(st, tuple) else (st,)
                outs, fin = _scan_layer(cell, x, st, sequence_length,
                                        bool(d), self.time_major)
                outs_dir.append(outs)
                finals.append(fin)
            x = outs_dir[0] if D == 1 else torch.cat(outs_dir, -1)
            if self.dropout > 0.0 and layer_i < L - 1:
                x = F.dropout(x, p=self.dropout, training=self.training)
        stacked = tuple(torch.stack([f[s] for f in finals], 0)
                        for s in range(n_state))
        return x, (stacked if n_state > 1 else stacked[0])


class SimpleRNN(_RNNBase):
    CELL = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation, **kw)


class LSTM(_RNNBase):
    CELL = LSTMCell


class GRU(_RNNBase):
    CELL = GRUCell

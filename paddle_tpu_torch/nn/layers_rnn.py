"""Recurrent layers: port of paddle_tpu/nn/layers_rnn.py (reference:
python/paddle/nn/layer/rnn.py — SimpleRNN, LSTM, GRU and their cells).

The reference runs the time loop in Python over eager ops (the cell is
left to XLA); so does the port, over the port's ops, which torch's
autograd records. Semantics kept: LSTM gates in the order i, f, g, o;
GRU's ``(1 - z) * c + z * h``; every weight and bias drawn from
``Uniform(-1/sqrt(hidden), 1/sqrt(hidden))``; dropout between layers
only; final states packed ``[layers * directions, B, H]``;
``sequence_length`` accepted and ignored, as the reference ignores it.
One difference: the multi-layer classes pass their ``weight_*_attr`` /
``bias_*_attr`` to the cells, as ``paddle.nn.LSTM`` does, where the
reference drops them.
"""
from __future__ import annotations

import math

from ..ops import manipulation as M
from ..ops.creation import full
from ..ops.linalg import matmul
from . import functional as F
from .initializer import Uniform
from .layer import Layer, LayerList

__all__ = ["BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN",
           "RNNCellBase", "SimpleRNN", "SimpleRNNCell", "_RNNBase"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        B = batch_ref.shape[batch_dim_idx]
        shape = shape or (self.hidden_size,)
        return full([B, *shape], init_value, dtype or "float32")

    def _weights(self, gates, input_size, hidden_size, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
        """weight_ih [g*H, in], weight_hh [g*H, H], bias_ih and bias_hh
        [g*H], drawn in that order from Uniform(+-1/sqrt(H))."""
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        n = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [n, input_size], weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [n, hidden_size], weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [n], bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [n], bias_hh_attr, is_bias=True, default_initializer=init)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._weights(1, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = F.tanh if self.activation == "tanh" else F.relu
        h = act(matmul(inputs, self.weight_ih, transpose_y=True)
                + self.bias_ih
                + matmul(states, self.weight_hh, transpose_y=True)
                + self.bias_hh)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._weights(4, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = (self.get_initial_states(inputs),
                      self.get_initial_states(inputs))
        h, c = states
        gates = (matmul(inputs, self.weight_ih, transpose_y=True)
                 + self.bias_ih
                 + matmul(h, self.weight_hh, transpose_y=True)
                 + self.bias_hh)
        i, f, g, o = M.split(gates, 4, axis=-1)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        g = F.tanh(g)
        c_new = f * c + i * g
        h_new = o * F.tanh(c_new)
        return h_new, (h_new, c_new)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._weights(3, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = states
        x_gates = matmul(inputs, self.weight_ih, transpose_y=True) \
            + self.bias_ih
        h_gates = matmul(h, self.weight_hh, transpose_y=True) + self.bias_hh
        xr, xz, xc = M.split(x_gates, 3, axis=-1)
        hr, hz, hc = M.split(h_gates, 3, axis=-1)
        r = F.sigmoid(xr + hr)
        z = F.sigmoid(xz + hz)
        c = F.tanh(xc + r * hc)
        h_new = (1.0 - z) * c + z * h  # paddle GRU convention
        return h_new, h_new

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """Runs a cell over the time axis."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        if not self.time_major:
            x = M.transpose(x, [1, 0, 2])
        if self.is_reverse:
            x = M.flip(x, [0])
        states = initial_states
        outs = []
        for t in range(x.shape[0]):
            out, states = self.cell(x[t], states)
            outs.append(out)
        y = M.stack(outs, axis=0)
        if self.is_reverse:
            y = M.flip(y, [0])
        if not self.time_major:
            y = M.transpose(y, [1, 0, 2])
        return y, states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        y_fw, s_fw = self.rnn_fw(inputs, states_fw)
        y_bw, s_bw = self.rnn_bw(inputs, states_bw)
        return M.concat([y_fw, y_bw], axis=-1), (s_fw, s_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        cell_cls = {"RNN_TANH": SimpleRNNCell, "RNN_RELU": SimpleRNNCell,
                    "LSTM": LSTMCell, "GRU": GRUCell}[mode]
        attrs = dict(weight_ih_attr=weight_ih_attr,
                     weight_hh_attr=weight_hh_attr,
                     bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)
        if mode in ("RNN_TANH", "RNN_RELU"):
            attrs["activation"] = "relu" if mode == "RNN_RELU" else "tanh"

        layers = []
        for i in range(num_layers):
            in_size = (input_size if i == 0
                       else hidden_size * self.num_directions)
            if bidirect:
                layers.append(BiRNN(cell_cls(in_size, hidden_size, **attrs),
                                    cell_cls(in_size, hidden_size, **attrs),
                                    time_major))
            else:
                layers.append(RNN(cell_cls(in_size, hidden_size, **attrs),
                                  is_reverse=(direction == "backward"),
                                  time_major=time_major))
        self.layer_list = LayerList(layers)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        final_states = []
        for i, rnn_l in enumerate(self.layer_list):
            init = None
            if initial_states is not None:
                init = self._slice_states(initial_states, i)
            x, st = rnn_l(x, init)
            final_states.append(st)
            if self.dropout > 0 and i < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        return x, self._pack_states(final_states)

    def _slice_states(self, initial_states, i):
        nd = self.num_directions

        def pick(s, j):
            return s[i * nd + j]
        if self.mode == "LSTM":
            h, c = initial_states
            if nd == 2:
                return ((pick(h, 0), pick(c, 0)), (pick(h, 1), pick(c, 1)))
            return (pick(h, 0), pick(c, 0))
        h = initial_states
        if nd == 2:
            return (pick(h, 0), pick(h, 1))
        return pick(h, 0)

    def _pack_states(self, final_states):
        nd = self.num_directions
        if self.mode == "LSTM":
            hs, cs = [], []
            for st in final_states:
                for h, c in (st if nd == 2 else (st,)):
                    hs.append(h)
                    cs.append(c)
            return (M.stack(hs, 0), M.stack(cs, 0))
        hs = []
        for st in final_states:
            hs += list(st) if nd == 2 else [st]
        return M.stack(hs, 0)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **attrs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **_rnn_attrs(attrs))


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **attrs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **_rnn_attrs(attrs))


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **attrs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **_rnn_attrs(attrs))


def _rnn_attrs(kw):
    """The parameter attributes among paddle.nn.LSTM's keywords (``name``
    and anything else are accepted and ignored, as the reference does)."""
    keys = ("weight_ih_attr", "weight_hh_attr", "bias_ih_attr",
            "bias_hh_attr")
    return {k: kw[k] for k in keys if k in kw}

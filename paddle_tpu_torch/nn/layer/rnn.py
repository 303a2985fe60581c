"""Recurrent layers — the counterpart of ``paddle_tpu/nn/layer/rnn.py``:
the cells ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, ``RNN`` and
``BiRNN`` over time, the stacks ``SimpleRNN``, ``LSTM`` and ``GRU``, and
beam search (``BeamSearchDecoder``, ``dynamic_decode``).

The cells are written on the port's tensor functions in the reference's
order: the gates split ``i, f, g, o`` (LSTM) and ``r, z, c`` (GRU, whose
candidate takes ``r * hc``, :138-150).  Parameters are the reference's by
name and shape (``weight_ih`` ``[gates * hidden, input]``, ``weight_hh``,
``bias_ih``, ``bias_hh``), drawn from ``Uniform(-1/sqrt(hidden),
1/sqrt(hidden))``, so the reference's ``state_dict()`` loads through
``set_state_dict`` as it is.  The time loop is a Python loop of eager ops,
as the reference's (:179-181); nothing in it reads the card back, so a
``Model(jit=True)`` step captures it whole.

The reference's gaps are kept: ``RNN.forward`` never reads
``sequence_length``, ``get_initial_states`` always gives float32 and
ignores ``dtype``, the stacks drop out between layers only, and
``dynamic_decode`` raises without initial states.
"""
from __future__ import annotations

import math

import torch

from ... import ops
from ...core.tensor import Tensor, to_tensor
from .. import initializer as I
from ..layer_base import Layer
from ..param_attr import ParamAttr
from .container import LayerList

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU", "BeamSearchDecoder",
           "dynamic_decode"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """Zeros (``init_value``) of ``(batch,) + shape`` on
        ``batch_ref``'s device, float32 whatever ``dtype`` says (as the
        reference, :27-38); a nested shape gives a tuple of states."""
        ref = to_tensor(batch_ref)._data
        batch = ref.shape[batch_dim_idx]
        shape = shape or self.state_shape

        def full(s):
            return Tensor(torch.full((batch,) + tuple(s), init_value,
                                     dtype=torch.float32, device=ref.device))
        if isinstance(shape, tuple) and shape and \
                isinstance(shape[0], (tuple, list)):
            return tuple(full(s) for s in shape)
        return full(shape)


def _cell_params(layer, input_size, hidden_size, gates, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
    std = 1.0 / math.sqrt(hidden_size)
    u = I.Uniform(-std, std)
    layer.weight_ih = layer.create_parameter(
        [gates * hidden_size, input_size],
        attr=ParamAttr._to_attr(weight_ih_attr), default_initializer=u)
    layer.weight_hh = layer.create_parameter(
        [gates * hidden_size, hidden_size],
        attr=ParamAttr._to_attr(weight_hh_attr), default_initializer=u)
    layer.bias_ih = None if bias_ih_attr is False else layer.create_parameter(
        [gates * hidden_size], attr=ParamAttr._to_attr(bias_ih_attr),
        is_bias=True, default_initializer=u)
    layer.bias_hh = None if bias_hh_attr is False else layer.create_parameter(
        [gates * hidden_size], attr=ParamAttr._to_attr(bias_hh_attr),
        is_bias=True, default_initializer=u)


def _gates(layer, inputs, h):
    """``inputs W_ih^T + b_ih`` and ``h W_hh^T + b_hh``."""
    x = ops.matmul(inputs, layer.weight_ih, transpose_y=True)
    if layer.bias_ih is not None:
        x = x + layer.bias_ih
    hh = ops.matmul(h, layer.weight_hh, transpose_y=True)
    if layer.bias_hh is not None:
        hh = hh + layer.bias_hh
    return x, hh


def _summed_gates(layer, inputs, h):
    """The gates' pre-activation, summed in the reference's order:
    ``((inputs W_ih^T + b_ih) + h W_hh^T) + b_hh``."""
    g = ops.matmul(inputs, layer.weight_ih, transpose_y=True)
    if layer.bias_ih is not None:
        g = g + layer.bias_ih
    g = g + ops.matmul(h, layer.weight_hh, transpose_y=True)
    if layer.bias_hh is not None:
        g = g + layer.bias_hh
    return g


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = ops.tanh if self.activation == "tanh" else ops.relu
        h = act(_summed_gates(self, inputs, states))
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, input_size, hidden_size, 4, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        h, c = states
        i, f, g, o = ops.split(_summed_gates(self, inputs, h), 4, axis=-1)
        i, f, o = ops.sigmoid(i), ops.sigmoid(f), ops.sigmoid(o)
        g = ops.tanh(g)
        new_c = f * c + i * g
        new_h = o * ops.tanh(new_c)
        return new_h, (new_h, new_c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, input_size, hidden_size, 3, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = states
        x, hh = _gates(self, inputs, h)
        xr, xz, xc = ops.split(x, 3, axis=-1)
        hr, hz, hc = ops.split(hh, 3, axis=-1)
        r = ops.sigmoid(xr + hr)
        z = ops.sigmoid(xz + hz)
        c = ops.tanh(xc + r * hc)
        new_h = (1.0 - z) * c + z * h
        return new_h, new_h


class RNN(Layer):
    """A cell over time (``time_major`` or batch-major inputs), forward or
    reversed."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        inputs = to_tensor(inputs)
        steps = inputs if self.time_major else \
            ops.transpose(inputs, [1, 0, 2])
        if self.is_reverse:
            steps = ops.flip(steps, axis=0)
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        states = initial_states
        outs = []
        for t in range(steps.shape[0]):
            out, states = self.cell(steps[t], states)
            outs.append(out)
        outputs = ops.stack(outs, axis=0)
        if self.is_reverse:
            outputs = ops.flip(outputs, axis=0)
        if not self.time_major:
            outputs = ops.transpose(outputs, [1, 0, 2])
        return outputs, states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (None, None) if initial_states is None else \
            initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length)
        return ops.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    _cell_cls = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **cell_kwargs):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        self.rnns = LayerList()
        attrs = dict(weight_ih_attr=weight_ih_attr,
                     weight_hh_attr=weight_hh_attr,
                     bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)

        def cell(in_size):
            return self._cell_cls(in_size, hidden_size, **cell_kwargs,
                                  **attrs)
        for layer_i in range(num_layers):
            in_size = input_size if layer_i == 0 else \
                hidden_size * self.num_directions
            if bidirect:
                self.rnns.append(BiRNN(cell(in_size), cell(in_size),
                                       time_major))
            else:
                self.rnns.append(RNN(cell(in_size), direction == "backward",
                                     time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        out = inputs
        final_states = []
        for i, rnn in enumerate(self.rnns):
            st = None if initial_states is None else \
                self._slice_states(initial_states, i)
            out, states = rnn(out, st, sequence_length)
            final_states.append(states)
            if self.dropout > 0.0 and i < self.num_layers - 1:
                out = ops.nn_ops.dropout(out, p=self.dropout,
                                         training=self.training)
        return out, self._merge_states(final_states)

    def _slice_states(self, initial_states, i):
        """Layer ``i``'s states of ``(num_layers * num_directions, batch,
        hidden)`` (an ``(h, c)`` pair for LSTM)."""
        base = i * self.num_directions

        def pick(s):
            if self.num_directions == 2:
                return (s[base], s[base + 1])
            return s[base]
        if isinstance(initial_states, (tuple, list)):
            h, c = initial_states
            if self.num_directions == 2:
                return ((pick(h)[0], pick(c)[0]), (pick(h)[1], pick(c)[1]))
            return (pick(h), pick(c))
        return pick(initial_states)

    def _merge_states(self, final_states):
        flat_h, flat_c = [], []
        for st in final_states:
            for state in (st if self.num_directions == 2 else (st,)):
                if isinstance(state, tuple):
                    flat_h.append(state[0])
                    flat_c.append(state[1])
                else:
                    flat_h.append(state)
        h = ops.stack(flat_h, axis=0)
        return (h, ops.stack(flat_c, axis=0)) if flat_c else h


class SimpleRNN(_RNNBase):
    _cell_cls = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation, **kwargs)


class LSTM(_RNNBase):
    _cell_cls = LSTMCell


class GRU(_RNNBase):
    _cell_cls = GRUCell


def _map(fn, states):
    """``fn`` over every Tensor of a nest of tuples and lists."""
    if isinstance(states, (tuple, list)):
        return type(states)(_map(fn, s) for s in states)
    return fn(states)


def _first(states):
    while isinstance(states, (tuple, list)):
        states = states[0]
    return states


class BeamSearchDecoder(Layer):
    """Beam search over a cell: each step scores every beam's extensions
    by their total log-probability and keeps the ``beam_size`` best of
    each batch row.  Beam 0 starts alone (the others at -1e9) and a
    finished beam extends with ``end_token`` at no cost, as the
    reference's (:340-358)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        super().__init__()
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        """``(first inputs [B * beam], states, log-probs, finished)``."""
        k = self.beam_size
        states = _map(lambda t: Tensor(torch.repeat_interleave(
            t._data, k, dim=0)), initial_cell_states)
        some = _first(initial_cell_states)._data
        B, dev = int(some.shape[0]), some.device
        ids = torch.full((B * k,), self.start_token, dtype=torch.int32,
                         device=dev)
        log_probs = torch.tensor([0.0] + [-1e9] * (k - 1),
                                 dtype=torch.float32, device=dev).repeat(B)
        finished = torch.zeros(B * k, dtype=torch.bool, device=dev)
        return Tensor(ids), states, log_probs, finished

    def step(self, inputs, states, log_probs, finished):
        """One expansion and pruning: ``(next ids, parent beams [B, beam],
        states, log-probs, finished)``."""
        x = self.embedding_fn(inputs) if self.embedding_fn is not None \
            else inputs
        out, new_states = self.cell(x, states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        # the search itself records no gradient: the reference computes
        # it on raw arrays, off its tape
        logits = (logits._data if isinstance(logits, Tensor) else
                  torch.as_tensor(logits)).detach()
        V = logits.shape[-1]
        step_lp = torch.log_softmax(logits, dim=-1)
        fin_row = torch.full((V,), -1e9, dtype=step_lp.dtype,
                             device=step_lp.device)
        fin_row[self.end_token] = 0.0
        step_lp = torch.where(finished[:, None], fin_row[None, :], step_lp)
        B = step_lp.shape[0] // self.beam_size
        total = (log_probs[:, None] + step_lp).reshape(B, self.beam_size * V)
        top_lp, top_idx = torch.topk(total, self.beam_size, dim=-1)
        parent = torch.div(top_idx, V, rounding_mode="floor").to(torch.int32)
        token = (top_idx % V).to(torch.int32)
        flat = (parent + (torch.arange(B, device=parent.device)
                          * self.beam_size)[:, None]).reshape(-1).long()
        new_states = _map(lambda t: Tensor(t._data[flat].detach()),
                          new_states)
        finished = finished[flat] | (token.reshape(-1) == self.end_token)
        return (Tensor(token.reshape(-1)), parent, new_states,
                top_lp.reshape(-1), finished)


def dynamic_decode(decoder, inits=None, max_step_num=100, **kwargs):
    """Run ``decoder`` until every beam has finished or ``max_step_num``
    steps, reading ``finished`` back each step as the reference does
    (:391); returns ``(ids [B, T, beam], final log-probs [B, beam])``."""
    from ..functional import gather_tree
    if inits is None:
        raise ValueError(
            "dynamic_decode requires the decoder's initial cell states "
            "(e.g. cell.get_initial_states(batch_ref))")
    inputs, states, log_probs, finished = decoder.initialize(inits)
    step_tokens, step_parents = [], []
    for _ in range(max_step_num):
        inputs, parent, states, log_probs, finished = decoder.step(
            inputs, states, log_probs, finished)
        B = parent.shape[0]
        step_tokens.append(inputs._data.reshape(B, decoder.beam_size))
        step_parents.append(parent)
        if bool(finished.all()):
            break
    seqs = gather_tree(Tensor(torch.stack(step_tokens)),
                       Tensor(torch.stack(step_parents)))
    return (Tensor(seqs._data.permute(1, 0, 2)),
            Tensor(log_probs.reshape(-1, decoder.beam_size)))

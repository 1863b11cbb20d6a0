"""Layer-class tail: port of paddle_tpu/nn/layers_extra.py — the fold and
unpool wrappers, Softmax2D and Swish, the loss-layer family, LayerDict,
and seq2seq beam-search decoding.

Reference: ``python/paddle/nn/layer/common.py`` (Fold/Unfold),
``layer/pooling.py`` (MaxUnPool1D/2D/3D), ``layer/loss.py`` (the *Loss
classes), ``layer/container.py:LayerDict``, ``layer/activation.py``
(Softmax2D, Swish), and ``python/paddle/nn/decode.py:153,994``
(BeamSearchDecoder, dynamic_decode). Each class wraps its functional op;
beam search keeps the reference's host bookkeeping in numpy (scores,
``np.argsort`` for the top beams, finished flags, lengths) around the
cell's steps on the device, finalized through ``functional.gather_tree``
as the reference's ``BeamSearchDecoder.finalize`` does.
"""
from __future__ import annotations

import numpy as np

from . import functional as F
from .layer import Layer

__all__ = [
    "BeamSearchDecoder", "Fold", "GaussianNLLLoss", "HSigmoidLoss",
    "LayerDict", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "MultiLabelSoftMarginLoss", "MultiMarginLoss", "PoissonNLLLoss",
    "RNNTLoss", "SoftMarginLoss", "Softmax2D", "Swish",
    "TripletMarginWithDistanceLoss", "Unfold", "dynamic_decode",
]


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._a = (output_sizes, kernel_sizes, strides, paddings,
                   dilations)

    def forward(self, x):
        return F.fold(x, *self._a)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._a = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self._a)


class _MaxUnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.output_size = padding, output_size

    def forward(self, x, indices):
        return type(self)._fn(x, indices, self.kernel_size, self.stride,
                              self.padding, output_size=self.output_size)


class MaxUnPool1D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool3d)


class Softmax2D(Layer):
    """Softmax over the channel axis of NCHW input (reference:
    layer/activation.py Softmax2D)."""

    def forward(self, x):
        if len(x.shape) not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3D/4D input, got {len(x.shape)}D")
        return F.softmax(x, axis=-3)


class Swish(Layer):
    def forward(self, x):
        return F.swish(x)


# ----------------------------------------------------------------- losses

class _LossLayer(Layer):
    """Common shell: stash ctor kwargs, forward to the functional op."""
    _fn = None
    _arg_names: tuple = ()

    def __init__(self, **kwargs):
        super().__init__()
        self._kw = kwargs

    def forward(self, *args):
        return type(self)._fn(*args, **self._kw)


class SoftMarginLoss(_LossLayer):
    _fn = staticmethod(F.soft_margin_loss)

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class MultiMarginLoss(_LossLayer):
    _fn = staticmethod(F.multi_margin_loss)

    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(p=p, margin=margin, weight=weight,
                         reduction=reduction)


class MultiLabelSoftMarginLoss(_LossLayer):
    _fn = staticmethod(F.multi_label_soft_margin_loss)

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class GaussianNLLLoss(_LossLayer):
    _fn = staticmethod(F.gaussian_nll_loss)

    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(full=full, epsilon=epsilon, reduction=reduction)


class PoissonNLLLoss(_LossLayer):
    _fn = staticmethod(F.poisson_nll_loss)

    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(log_input=log_input, full=full, epsilon=epsilon,
                         reduction=reduction)


class TripletMarginWithDistanceLoss(_LossLayer):
    _fn = staticmethod(F.triplet_margin_with_distance_loss)

    def __init__(self, distance_function=None, margin=1.0,
                 swap=False, reduction="mean", name=None):
        super().__init__(distance_function=distance_function,
                         margin=margin, swap=swap, reduction=reduction)


class RNNTLoss(_LossLayer):
    """Reference default is fastemit_lambda=0.001; the functional op
    computes the exact forward-DP loss without FastEmit, so the layer
    defaults to 0.0 and a nonzero lambda raises."""
    _fn = staticmethod(F.rnnt_loss)

    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean",
                 name=None):
        super().__init__(blank=blank, fastemit_lambda=fastemit_lambda,
                         reduction=reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid classifier (reference: layer/loss.py
    HSigmoidLoss — owns the path weight [C - 1, D], XavierUniform, and
    bias [C - 1, 1], zeros, registered as ``p0`` and ``p1`` as the
    reference registers them)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        from ..framework.dtype import convert_dtype
        from ..tensor import Parameter
        from .initializer import Constant, XavierUniform
        self.num_classes = num_classes
        f32 = convert_dtype("float32")
        w = XavierUniform()((num_classes - 1, feature_size), f32)
        object.__setattr__(self, "weight", self._param(Parameter(w)))
        bias = None
        if bias_attr is not False:
            bias = self._param(Parameter(
                Constant(0.0)((num_classes - 1, 1), f32)))
        object.__setattr__(self, "bias", bias)

    def _param(self, p):
        self.add_parameter(f"p{len(self._pd_params)}", p)
        return p

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes,
                               self.weight, bias=self.bias)


# -------------------------------------------------------------- LayerDict

class LayerDict(Layer):
    """Dict-style sublayer container (reference: layer/container.py
    LayerDict — ordered, insertion API mirrors dict)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(str(key), layer)

    def __delitem__(self, key):
        del self._sub_layers[str(key)]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        layer = self._sub_layers[key]
        del self._sub_layers[key]
        return layer

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        items = (sublayers.items() if isinstance(sublayers, dict)
                 else sublayers)
        for key, layer in items:
            self[key] = layer
        return self


# ------------------------------------------------------------ beam search

class BeamSearchDecoder:
    """Beam-search wrapper over an RNN cell (reference:
    ``python/paddle/nn/decode.py:153``). The cell's inputs and states are
    tiled to ``[batch * beam_size, ...]``; each step scores
    log-softmax(cell output), extends beams, and finished beams only
    extend with ``end_token`` at zero added cost."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token, self.end_token = start_token, end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam, ...] (repeat each batch row)."""
        from ..ops.manipulation import repeat_interleave
        return repeat_interleave(x, beam_size, axis=0)


def _top_beams(flat, beam):
    """The ``beam`` best of each row of the [B, beam * V] scores, best
    first, as the reference picks them (``np.argsort`` of the negated
    scores, not a stable sort)."""
    return np.argsort(-flat, axis=1)[:, :beam]


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """Run ``decoder`` until every beam emits ``end_token`` or
    ``max_step_num`` steps elapse (reference: ``decode.py:994``).
    Returns ``(predicted_ids, sequence_lengths)``: ``predicted_ids`` is
    ``[batch, T, beam]`` after ``gather_tree`` (the reference's finalize
    step), beams sorted best-first. The cell runs on the initial states'
    device; the scores and the top-``beam`` choice of each step are
    numpy on the host, as in the reference."""
    from ..ops.manipulation import gather
    from ..tensor import no_grad, to_tensor

    cell = decoder.cell
    beam = decoder.beam_size
    end = decoder.end_token
    if inits is None:
        raise ValueError("dynamic_decode requires initial states "
                         "(pass inits=cell.get_initial_states(...) )")
    states = inits
    s0 = states[0] if isinstance(states, (tuple, list)) else states
    batch = int(s0.shape[0])
    place = s0.place

    def tile(t):
        return BeamSearchDecoder.tile_beam_merge_with_batch(t, beam)
    states = (tuple(tile(s) for s in states)
              if isinstance(states, (tuple, list)) else tile(states))

    neg_inf = -1e9
    scores = np.full((batch, beam), neg_inf, np.float32)
    scores[:, 0] = 0.0            # all beams start identical: keep one
    finished = np.zeros((batch, beam), bool)
    token = to_tensor(np.full((batch * beam,), decoder.start_token,
                              np.int64), place=place)
    step_ids, step_parents = [], []
    lengths = np.zeros((batch, beam), np.int64)

    with no_grad():
        for _ in range(max_step_num):
            inp = decoder.embedding_fn(token) if decoder.embedding_fn \
                else token
            out, new_states = cell(inp, states)
            if decoder.output_fn is not None:
                out = decoder.output_fn(out)
            logp = np.asarray(F.log_softmax(out, axis=-1).numpy()
                              ).reshape(batch, beam, -1)
            vocab = logp.shape[-1]
            # finished beams: only the end token, at zero additional cost
            fin_row = np.full((vocab,), neg_inf, np.float32)
            fin_row[end] = 0.0
            logp = np.where(finished[:, :, None], fin_row[None, None, :],
                            logp)
            total = scores[:, :, None] + logp          # [B, beam, V]
            flat = total.reshape(batch, beam * vocab)
            top = _top_beams(flat, beam)               # [B, beam]
            scores = np.take_along_axis(flat, top, axis=1)
            parent = top // vocab
            word = top % vocab
            finished = np.take_along_axis(finished, parent, axis=1) \
                | (word == end)
            lengths = np.take_along_axis(lengths, parent, axis=1) \
                + (~finished)
            step_ids.append(word)
            step_parents.append(parent)
            # reorder the cell states by parent beam, on their device
            order = to_tensor((parent + np.arange(batch)[:, None] * beam
                               ).reshape(-1), place=place)
            states = (tuple(gather(s, order) for s in new_states)
                      if isinstance(new_states, (tuple, list))
                      else gather(new_states, order))
            token = to_tensor(word.reshape(-1).astype(np.int64), place=place)
            if finished.all():
                break

    final = F.gather_tree(to_tensor(np.stack(step_ids)),
                          to_tensor(np.stack(step_parents)))
    predicted = to_tensor(np.transpose(np.asarray(final.numpy()), (1, 0, 2)))
    return predicted, to_tensor(lengths)

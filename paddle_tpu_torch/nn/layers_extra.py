"""Layer-class tail: port of paddle_tpu/nn/layers_extra.py — the fold and
unpool wrappers, Softmax2D and Swish, the loss layers whose functionals the
port has, and LayerDict.

Reference: ``python/paddle/nn/layer/common.py`` (Fold/Unfold),
``layer/pooling.py`` (MaxUnPool1D/2D/3D), ``layer/loss.py`` (the *Loss
classes), ``layer/container.py:LayerDict`` and ``layer/activation.py``
(Softmax2D, Swish). Each class wraps its functional op.
TripletMarginWithDistanceLoss, RNNTLoss, HSigmoidLoss, BeamSearchDecoder
and dynamic_decode wait for their functionals in a later slice.
"""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = [
    "Fold", "GaussianNLLLoss", "LayerDict", "MaxUnPool1D", "MaxUnPool2D",
    "MaxUnPool3D", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
    "PoissonNLLLoss", "SoftMarginLoss", "Softmax2D", "Swish", "Unfold",
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

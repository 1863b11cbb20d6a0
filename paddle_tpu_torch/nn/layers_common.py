"""Common layers: port of paddle_tpu/nn/layers_common.py (reference:
python/paddle/nn/layer/common.py, activation.py). ``Linear`` keeps
paddle's [in, out] weight and computes x @ W + b, so state_dicts cross
between the packages unchanged."""
from __future__ import annotations

import torch

from .initializer import Constant, Normal, XavierNormal
from .layer import Layer
from . import functional as F


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = x @ W + b, W: [in, out] (reference: nn/layer/common.py Linear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """Lookup table [num_embeddings, embedding_dim]. ``sparse=True`` is
    accepted; the gradient is dense (the reference's SelectedRows rows-only
    gradient waits for a later slice)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0)
            if weight_attr is None else None)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._value[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ..ops.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        from ..ops.manipulation import reshape
        ax = self.axis % x.ndim
        new_shape = x.shape[:ax] + list(self.shape) + x.shape[ax + 1:]
        return reshape(x, new_shape)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-06, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


def _pad_layer(n, fmt_default):
    class _Pad(Layer):
        def __init__(self, padding, mode="constant", value=0.0,
                     data_format=fmt_default, name=None):
            super().__init__()
            self.padding = padding
            self.mode = mode
            self.value = value
            self.data_format = data_format

        def forward(self, x):
            return F.pad(x, self.padding, self.mode, self.value,
                         self.data_format)
    return _Pad


Pad1D = _pad_layer(1, "NCL")
Pad2D = _pad_layer(2, "NCHW")
Pad3D = _pad_layer(3, "NCDHW")


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


# ---- activation layers ---------------------------------------------------
def _act_layer(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            params = dict(defaults)
            keys = list(defaults)
            for i, a in enumerate(args):
                params[keys[i]] = a
            params.update({k: v for k, v in kwargs.items() if k in params})
            self._params = params

        def forward(self, x):
            return fn(x, **self._params)

    _Act.__name__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu, approximate=False)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Silu = _act_layer("Silu", F.silu)
Tanh = _act_layer("Tanh", F.tanh)
Softplus = _act_layer("Softplus", F.softplus, beta=1.0, threshold=20.0)
Softsign = _act_layer("Softsign", F.softsign)
Softshrink = _act_layer("Softshrink", F.softshrink, threshold=0.5)
Hardshrink = _act_layer("Hardshrink", F.hardshrink, threshold=0.5)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardtanh = _act_layer("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
ELU = _act_layer("ELU", F.elu, alpha=1.0)
CELU = _act_layer("CELU", F.celu, alpha=1.0)
SELU = _act_layer("SELU", F.selu)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu, negative_slope=0.01)
Mish = _act_layer("Mish", F.mish)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)
Softmax = _act_layer("Softmax", F.softmax, axis=-1)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax, axis=-1)
ThresholdedReLU = _act_layer("ThresholdedReLU", F.thresholded_relu,
                             threshold=1.0)
Maxout = _act_layer("Maxout", F.maxout, groups=2, axis=1)
GLU = _act_layer("GLU", F.glu, axis=-1)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)

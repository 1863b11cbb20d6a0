"""Conv/pool/norm layers: port of paddle_tpu/nn/layers_conv.py (reference:
python/paddle/nn/layer/conv.py, pooling.py, norm.py)."""
from __future__ import annotations

import math

import numpy as np
import torch

from .initializer import Constant, KaimingUniform, Uniform
from .layer import Layer
from . import functional as F
from .functional.conv import _norm_tuple


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _norm_tuple(kernel_size, n)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.output_padding = output_padding
        self._n = n
        self._transpose = transpose
        if transpose:
            # paddle transpose-conv weight: [in, out/groups, *k]
            w_shape = [in_channels, out_channels // groups, *self.kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups, *self.kernel_size]
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in, nonlinearity="leaky_relu",
                                               negative_slope=math.sqrt(5.0)))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr, is_bias=True,
                default_initializer=Uniform(-bound, bound))


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


# ---- pooling layers ------------------------------------------------------
def _pool_layer(name, fn, has_stride=True):
    class _Pool(Layer):
        def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
            super().__init__()
            self.kernel_size = kernel_size
            self.stride = stride
            self.padding = padding
            self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return fn(x, self.kernel_size, self.stride, self.padding,
                      **self.kwargs)
    _Pool.__name__ = name
    return _Pool


MaxPool1D = _pool_layer("MaxPool1D", F.max_pool1d)
MaxPool2D = _pool_layer("MaxPool2D", F.max_pool2d)
MaxPool3D = _pool_layer("MaxPool3D", F.max_pool3d)
AvgPool1D = _pool_layer("AvgPool1D", F.avg_pool1d)
AvgPool2D = _pool_layer("AvgPool2D", F.avg_pool2d)
AvgPool3D = _pool_layer("AvgPool3D", F.avg_pool3d)


def _adaptive_pool_layer(name, fn):
    class _Pool(Layer):
        def __init__(self, output_size, **kwargs):
            super().__init__()
            self.output_size = output_size
            self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return fn(x, self.output_size, **self.kwargs)
    _Pool.__name__ = name
    return _Pool


AdaptiveAvgPool1D = _adaptive_pool_layer("AdaptiveAvgPool1D", F.adaptive_avg_pool1d)
AdaptiveAvgPool2D = _adaptive_pool_layer("AdaptiveAvgPool2D", F.adaptive_avg_pool2d)
AdaptiveAvgPool3D = _adaptive_pool_layer("AdaptiveAvgPool3D", F.adaptive_avg_pool3d)
AdaptiveMaxPool1D = _adaptive_pool_layer("AdaptiveMaxPool1D", F.adaptive_max_pool1d)
AdaptiveMaxPool2D = _adaptive_pool_layer("AdaptiveMaxPool2D", F.adaptive_max_pool2d)
AdaptiveMaxPool3D = _adaptive_pool_layer("AdaptiveMaxPool3D", F.adaptive_max_pool3d)


# ---- norm layers ---------------------------------------------------------
class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)
        from ..ops.creation import zeros, ones
        self.register_buffer("_mean", zeros([num_features]))
        self.register_buffer("_variance", ones([num_features]))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)


class BatchNorm(_BatchNormBase):
    """Legacy paddle.nn.BatchNorm(num_channels)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act == "relu":
            out = F.relu(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BN. On TPU, batch stats are all-reduced over the 'dp'
    mesh axis inside pjit (reference: nn/layer/norm.py SyncBatchNorm over
    NCCL). Single-process eager falls back to local stats."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      data_format=layer.data_format)
            new.weight = layer.weight
            new.bias = layer.bias
            for name in ("_mean", "_variance"):
                new.register_buffer(name, getattr(layer, name))
            return new
        return layer


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon, data_format=self.data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon
        from ..ops.random_ops import randn
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.register_buffer("weight_u", randn([h]))
        self.register_buffer("weight_v", randn([w]))

    def forward(self, weight):
        from ..ops import manipulation as M
        w_mat = M.moveaxis(weight, self.dim, 0)
        shape = w_mat.shape
        w2 = M.reshape(w_mat, [shape[0], -1])
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = F.normalize(w2.T @ u, axis=0, epsilon=self.epsilon)
            u = F.normalize(w2 @ v, axis=0, epsilon=self.epsilon)
        with torch.no_grad():
            self.weight_u._value.copy_(u._value)
            self.weight_v._value.copy_(v._value)
        sigma = u @ w2 @ v
        return weight / sigma

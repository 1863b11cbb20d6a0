"""nn.utils: port of paddle_tpu/nn/utils.py (reference:
python/paddle/nn/utils/ — weight_norm, spectral_norm,
parameters_to_vector).

``weight_norm`` keeps the reference's reparameterisation ``w = g * v /
||v||`` recomputed by a forward pre-hook, with the reference's norm read
off ``v``'s value: the gradient treats ``||v||`` as a constant, as the
reference's does.
"""
from __future__ import annotations

import torch

from ..tensor import Parameter, Tensor
from .clip import clip_grad_norm_, clip_grad_value_  # noqa: F401

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "remove_weight_norm", "spectral_norm", "vector_to_parameters",
           "weight_norm"]


def parameters_to_vector(parameters, name=None):
    from ..ops.manipulation import concat, reshape
    return concat([reshape(p, [-1]) for p in parameters], axis=0)


def vector_to_parameters(vec, parameters, name=None):
    """Write consecutive slices of ``vec`` into ``parameters`` (in place:
    a Parameter keeps its identity)."""
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.size
            p._value.copy_(vec._value[offset:offset + n].reshape(
                p._value.shape))
            offset += n


def _norm_except(w, dim, keepdim):
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(w)))
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(w), axes, keepdim=keepdim))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize weight = g * v / ||v||, recomputed on each forward
    by a pre-hook (reference: nn/utils/weight_norm_hook.py)."""
    w = getattr(layer, name)._value.detach()
    g = Parameter(_norm_except(w, dim, False), name=f"{name}_g")
    v = Parameter(w.clone(), name=f"{name}_v")
    delattr(layer, name)
    layer.add_parameter(f"{name}_g", g)
    layer.add_parameter(f"{name}_v", v)
    layer._weight_norm_cfg = (name, dim)

    def _compute(layer_, inputs):
        g_ = layer_._pd_params[f"{name}_g"]
        v_ = layer_._pd_params[f"{name}_v"]
        vv = v_._value.detach()
        if dim is None:
            w_ = v_ * (g_ / Tensor(_norm_except(vv, None, False)))
        else:
            shape = [1] * vv.dim()
            shape[dim] = -1
            w_ = v_ * (g_.reshape(shape) / Tensor(_norm_except(vv, dim,
                                                               True)))
        object.__setattr__(layer_, name, w_)
        return None

    layer._weight_norm_hook = layer.register_forward_pre_hook(_compute)
    _compute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    w = getattr(layer, name)
    delattr(layer, f"{name}_g")
    delattr(layer, f"{name}_v")
    if name in layer.__dict__:
        object.__delattr__(layer, name)
    layer.add_parameter(name, Parameter(w._value.detach().clone()))
    layer._weight_norm_hook.remove()
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    from .layers_conv import SpectralNorm as _SN
    weight = getattr(layer, name)
    if dim is None:
        dim = 0
    sn = _SN(list(weight.shape), dim=dim, power_iters=n_power_iterations,
             epsilon=eps)
    layer.add_sublayer(f"{name}_spectral_norm", sn)
    orig = layer._pd_params[name]
    delattr(layer, name)
    layer.add_parameter(f"{name}_orig", orig)

    def _compute(layer_, inputs):
        w = sn(layer_._pd_params[f"{name}_orig"])
        object.__setattr__(layer_, name, w)
        return None

    layer.register_forward_pre_hook(_compute)
    _compute(layer, None)
    return layer

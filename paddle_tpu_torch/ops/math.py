"""Math ops: port of paddle_tpu/ops/math.py (reference:
python/paddle/tensor/math.py): elementwise, reductions, cumulative. Each is
a stock torch call on the held values; results fold to the reference's
32-bit dtypes, so an int32 sum stays int32 and an int mean is float32."""
from __future__ import annotations

import itertools
import sys

import numpy as np
import torch

from ..framework.dtype import to_torch
from ..tensor import Tensor, def_op

_this = sys.modules[__name__]


def _float_of(x):
    """x as the float dtype jnp computes its float functions in."""
    return x if (x.is_floating_point() or x.is_complex()) \
        else x.to(torch.float32)


def _tensor(y, like):
    """A Python number as a 0-dim tensor on ``like``'s device (it promotes
    as jax's weakly typed scalars do)."""
    return y if isinstance(y, torch.Tensor) else torch.as_tensor(
        y, device=like.device)


# ---- simple unary ops, generated en masse -------------------------------
_UNARY = {
    "abs": torch.abs, "acos": torch.acos, "acosh": torch.acosh,
    "asin": torch.asin, "asinh": torch.asinh, "atan": torch.atan,
    "atanh": torch.atanh, "ceil": torch.ceil, "cos": torch.cos,
    "cosh": torch.cosh, "digamma": lambda x: torch.digamma(_float_of(x)),
    "erf": torch.erf, "erfinv": torch.erfinv, "exp": torch.exp,
    "expm1": torch.expm1, "floor": torch.floor,
    "frac": lambda x: x - torch.trunc(x),
    "i0": lambda x: torch.special.i0(_float_of(x)),
    "i0e": lambda x: torch.special.i0e(_float_of(x)),
    "i1": lambda x: torch.special.i1(_float_of(x)),
    "i1e": lambda x: torch.special.i1e(_float_of(x)),
    "lgamma": lambda x: torch.lgamma(_float_of(x)),
    "log": torch.log, "log10": torch.log10, "log1p": torch.log1p,
    "log2": torch.log2, "neg": torch.neg,
    "reciprocal": lambda x: torch.reciprocal(_float_of(x)),
    "round": torch.round, "rsqrt": torch.rsqrt, "sigmoid": torch.sigmoid,
    "sign": torch.sign, "sin": torch.sin, "sinh": torch.sinh,
    "sqrt": torch.sqrt, "square": torch.square, "tan": torch.tan,
    "tanh": torch.tanh, "trunc": torch.trunc, "angle": torch.angle,
    "conj": lambda x: torch.conj(x).resolve_conj(),
    "real": lambda x: torch.real(x).clone() if x.is_complex() else x.clone(),
    "imag": lambda x: torch.imag(x).clone() if x.is_complex()
    else torch.zeros_like(x),
}

for _name, _fn in _UNARY.items():
    def _make(fn=_fn, name=_name):
        @def_op(name)
        def op(x, name=None, _fn=fn):
            return _fn(x)
        op.__name__ = name
        return op
    setattr(_this, _name, _make())


# ---- binary elementwise -------------------------------------------------
def _binary(name, fn):
    @def_op(name)
    def op(x, y, name=None):
        if not isinstance(x, torch.Tensor):
            x = _tensor(x, y)
        return fn(x, _tensor(y, x))
    op.__name__ = name
    return op


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
mod = _binary("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow = _binary("pow", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
logaddexp = _binary("logaddexp", torch.logaddexp)
heaviside = _binary("heaviside", torch.heaviside)
hypot = _binary("hypot", torch.hypot)
copysign = _binary("copysign", torch.copysign)
nextafter = _binary("nextafter", torch.nextafter)
ldexp = _binary("ldexp", torch.ldexp)
gammaincc = _binary("gammaincc", torch.special.gammaincc)
gammainc = _binary("gammainc", torch.special.gammainc)


@def_op("divide_int_true")
def _true_divide(x, y):
    return torch.true_divide(x, _tensor(y, x))


@def_op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s = scale.to(x.dtype) if isinstance(scale, torch.Tensor) \
        else torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(bias, dtype=x.dtype, device=x.device)
    if bias_after_scale:
        return x * s + b
    return (x + b) * s


@def_op("clip")
def clip(x, min=None, max=None, name=None):
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


@def_op("lerp")
def lerp(x, y, weight, name=None):
    return x + weight * (y - x)


@def_op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


@def_op("multiplex")
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


@def_op("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * torch.matmul(x, y)


@def_op("inner")
def inner(x, y, name=None):
    return torch.inner(x, y)


@def_op("outer")
def outer(x, y, name=None):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@def_op("kron")
def kron(x, y, name=None):
    return torch.kron(x, y)


@def_op("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@def_op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).clone()


# ---- reductions ---------------------------------------------------------
def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """The dims a reduction over ``axis`` reduces (all for None)."""
    axis = _norm_axis(axis)
    if axis is None:
        return tuple(range(x.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _reduce(fn):
    def run(x, axis=None, keepdims=False):
        dims = _dims(x, axis)
        if x.dim() == 0:
            return fn(x, (), keepdims)
        return fn(x, dims, keepdims)
    return run


def _sum(x, dims, keep):
    return torch.sum(x, dims, keepdim=keep) if dims else x.clone()


def _mean(x, dims, keep):
    return torch.mean(_float_of(x), dims, keepdim=keep) if dims \
        else _float_of(x).clone()


def _amax(x, dims, keep):
    return torch.amax(x, dims, keepdim=keep) if dims else x.clone()


def _amin(x, dims, keep):
    return torch.amin(x, dims, keepdim=keep) if dims else x.clone()


def _prod(x, dims, keep):
    out = x
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        out = torch.prod(out, d, keepdim=keep)
    return out


def _nansum(x, dims, keep):
    return torch.nansum(x, dims, keepdim=keep)


def _nanmean(x, dims, keep):
    return torch.nanmean(_float_of(x), dims, keepdim=keep)


def _logsumexp(x, dims, keep):
    return torch.logsumexp(_float_of(x), dims, keepdim=keep)


def _all(x, dims, keep):
    out = x.bool()
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        out = torch.all(out, d, keepdim=keep)
    return out


def _any(x, dims, keep):
    out = x.bool()
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        out = torch.any(out, d, keepdim=keep)
    return out


def _reduction(name, fn, has_dtype=False):
    red = _reduce(fn)
    if has_dtype:
        @def_op(name)
        def op(x, axis=None, dtype=None, keepdim=False, name=None):
            r = red(x, axis, keepdim)
            if dtype is not None:
                r = r.to(to_torch(dtype))
            return r
    else:
        @def_op(name)
        def op(x, axis=None, keepdim=False, name=None):
            return red(x, axis, keepdim)
    op.__name__ = name
    return op


sum = _reduction("sum", _sum, has_dtype=True)
mean = _reduction("mean", _mean)
max = _reduction("max", _amax)
min = _reduction("min", _amin)
prod = _reduction("prod", _prod, has_dtype=True)
amax = _reduction("amax", _amax)
amin = _reduction("amin", _amin)
nansum = _reduction("nansum", _nansum, has_dtype=True)
nanmean = _reduction("nanmean", _nanmean)
logsumexp = _reduction("logsumexp", _logsumexp)
all = _reduction("all", _all)
any = _reduction("any", _any)


@def_op("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(_float_of(x), _dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@def_op("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(_float_of(x), _dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _over_axis(fn, x, axis, keepdim):
    """Apply a one-dim reduction ``fn(x, dim)`` over ``axis`` (None: the
    flattened tensor), as numpy's median and quantile do."""
    axis = _norm_axis(axis)
    if axis is None:
        out = fn(x.reshape(-1), 0)
        return out.reshape((1,) * x.dim()) if keepdim else out
    dims = axis if isinstance(axis, tuple) else (axis,)
    dims = tuple(sorted(d % x.dim() for d in dims))
    rest = [d for d in range(x.dim()) if d not in dims]
    xm = x.permute(*rest, *dims).reshape(
        *[x.shape[d] for d in rest], -1)
    out = fn(xm, -1)
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d if out.dim() >= d else -1)
    return out


@def_op("median")
def median(x, axis=None, keepdim=False, name=None):
    return _over_axis(lambda v, d: torch.quantile(_float_of(v), 0.5, dim=d),
                      x, axis, keepdim)


@def_op("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _over_axis(
        lambda v, d: torch.nanquantile(_float_of(v), 0.5, dim=d),
        x, axis, keepdim)


def _quantile(fn, x, q, axis, keepdim, interpolation):
    qt = torch.as_tensor(q, dtype=_float_of(x).dtype, device=x.device)
    out = _over_axis(lambda v, d: fn(_float_of(v), qt, dim=d,
                                     interpolation=interpolation),
                     x, axis, False)
    if keepdim:
        dims = _dims(x, axis)
        shape = list(x.shape)
        for d in dims:
            shape[d % x.dim()] = 1
        out = out.reshape(tuple(qt.shape) + tuple(shape))
    return out


@def_op("quantile")
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


@def_op("nanquantile")
def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


@def_op("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _sum((x != 0), _dims(x, axis), keepdim) if x.dim() \
        else (x != 0).to(torch.int32)


# ---- cumulative ---------------------------------------------------------
@def_op("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    r = torch.cumsum(x, int(axis))
    return r.to(to_torch(dtype)) if dtype else r


@def_op("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    r = torch.cumprod(x, int(dim))
    return r.to(to_torch(dtype)) if dtype else r


@def_op("cummax")
def cummax(x, axis=None, dtype="int64", name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    v, i = torch.cummax(x, int(axis))
    return v, i.to(to_torch(dtype))


@def_op("cummin")
def cummin(x, axis=None, dtype="int64", name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    v, i = torch.cummin(x, int(axis))
    return v, i.to(to_torch(dtype))


@def_op("logcumsumexp")
def logcumsumexp(x, axis=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, int(axis))


@def_op("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


# ---- misc ---------------------------------------------------------------
@def_op("isfinite")
def isfinite(x, name=None):
    return torch.isfinite(x)


@def_op("isinf")
def isinf(x, name=None):
    return torch.isinf(x)


@def_op("isnan")
def isnan(x, name=None):
    return torch.isnan(x)


@def_op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@def_op("deg2rad")
def deg2rad(x, name=None):
    return torch.deg2rad(_float_of(x))


@def_op("rad2deg")
def rad2deg(x, name=None):
    return torch.rad2deg(_float_of(x))


@def_op("gcd")
def gcd(x, y, name=None):
    return torch.gcd(x, _tensor(y, x))


@def_op("lcm")
def lcm(x, y, name=None):
    return torch.lcm(x, _tensor(y, x))


@def_op("take")
def take(x, index, mode="raise", name=None):
    flat = x.reshape(-1)
    idx = index.reshape(-1).long()
    n = flat.shape[0]
    if mode == "raise":
        if bool(((idx < -n) | (idx >= n)).any()):
            raise IndexError(
                f"take: index out of range for tensor of {n} elements")
        mode = "clip"
    idx = torch.where(idx < 0, idx + n, idx)
    idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
    return flat[idx].reshape(index.shape)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@def_op("increment")
def increment(x, value=1.0, name=None):
    return x + torch.as_tensor(value, dtype=x.dtype, device=x.device)


@def_op("polygamma")
def polygamma(x, n, name=None):
    return torch.polygamma(int(n), _float_of(x))


@def_op("renorm")
def renorm(x, p, axis, max_norm, name=None):
    dims = [d for d in range(x.dim()) if d != axis]
    norms = torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


@def_op("frexp")
def frexp(x, name=None):
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


@def_op("logit")
def logit(x, eps=None, name=None):
    """log(x / (1 - x)), with an optional clamp to [eps, 1 - eps]."""
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


@def_op("sgn")
def sgn(x, name=None):
    """sign for real, x/|x| for complex."""
    return torch.sgn(x)


@def_op("add_n")
def add_n(inputs, name=None):
    if not isinstance(inputs, (list, tuple)):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


@def_op("trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x=x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@def_op("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.cumulative_trapezoid(y, x=x, dim=axis)
    return torch.cumulative_trapezoid(y, dx=1.0 if dx is None else dx,
                                      dim=axis)


@def_op("vander")
def vander(x, n=None, increasing=False, name=None):
    return torch.vander(x, N=n, increasing=increasing)


@def_op("signbit")
def signbit(x, name=None):
    return torch.signbit(x)


@def_op("sinc")
def sinc(x, name=None):
    return torch.sinc(_float_of(x))


@def_op("logaddexp2")
def logaddexp2(x, y, name=None):
    return torch.logaddexp2(x, _tensor(y, x))


@def_op("isreal")
def isreal(x, name=None):
    return torch.isreal(x)


@def_op("combinations")
def combinations(x, r=2, with_replacement=False, name=None):
    """All r-combinations of a 1-D tensor."""
    n = x.shape[0]
    idx = (itertools.combinations_with_replacement(range(n), r)
           if with_replacement else itertools.combinations(range(n), r))
    idx = torch.as_tensor(np.asarray(list(idx), np.int64).reshape(-1, r),
                          device=x.device)
    return x[idx]


@def_op("nanargmax")
def nanargmax(x, axis=None, keepdim=False, name=None):
    filled = torch.where(torch.isnan(x), torch.full_like(x, -float("inf")),
                         x)
    if axis is None:
        return torch.argmax(filled)
    return torch.argmax(filled, int(axis), keepdim=keepdim)


@def_op("nanargmin")
def nanargmin(x, axis=None, keepdim=False, name=None):
    filled = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    if axis is None:
        return torch.argmin(filled)
    return torch.argmin(filled, int(axis), keepdim=keepdim)


@def_op("bitwise_left_shift")
def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return torch.bitwise_left_shift(x, _tensor(y, x))


@def_op("bitwise_right_shift")
def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    y = _tensor(y, x)
    if is_arithmetic:
        return torch.bitwise_right_shift(x, y)
    # logical shift: shift the unsigned view
    bits = x.element_size() * 8
    wide = x.to(torch.int64) & ((1 << bits) - 1)
    return torch.bitwise_right_shift(wide, y.to(torch.int64)).to(x.dtype)



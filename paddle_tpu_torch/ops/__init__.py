"""Operators of the port: the eager op library over ``Tensor`` (port of
paddle_tpu/ops/__init__.py: creation, math, manipulation, linalg, logic,
search, attribute, random_ops, array, einsum, with the operator overloads
and the Tensor-method attachment of the reference's monkey_patch_tensor)
and the hand-written kernels under ``ops.kernels``."""
from __future__ import annotations

import torch

from ..tensor import Tensor, def_op, rebind_inplace
from .array import (array_length, array_read, array_write,  # noqa: F401
                    create_array, tensor_array_to_tensor)
from .attribute import (is_complex, is_floating_point,  # noqa: F401
                        is_integer, rank)
from .creation import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random_ops import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
# the modules themselves, after the star imports (a module's own imports,
# e.g. the stdlib ``math``, must not shadow them)
from . import (array, attribute, creation, linalg, logic,  # noqa: E402
               manipulation, math, random_ops, search)


# --------------------------------------------------------------------------
# Operator overloads
# --------------------------------------------------------------------------
def _swap(fn):
    def rop(self, other):
        if not isinstance(other, Tensor):
            other = creation.to_tensor(other, place=self._value.device)
        return fn(other, self)
    return rop


@def_op("divide")
def _div(x, y):
    # paddle: int / int is a float division
    return torch.true_divide(x, math._tensor(y, x))


Tensor.__add__ = lambda s, o: math.add(s, o)
Tensor.__radd__ = lambda s, o: math.add(s, o)
Tensor.__sub__ = lambda s, o: math.subtract(s, o)
Tensor.__rsub__ = _swap(math.subtract)
Tensor.__mul__ = lambda s, o: math.multiply(s, o)
Tensor.__rmul__ = lambda s, o: math.multiply(s, o)
Tensor.__truediv__ = lambda s, o: _div(s, o)
Tensor.__rtruediv__ = _swap(_div)
Tensor.__floordiv__ = lambda s, o: math.floor_divide(s, o)
Tensor.__rfloordiv__ = _swap(math.floor_divide)
Tensor.__mod__ = lambda s, o: math.mod(s, o)
Tensor.__rmod__ = _swap(math.mod)
Tensor.__pow__ = lambda s, o: math.pow(s, o)
Tensor.__rpow__ = _swap(math.pow)
Tensor.__neg__ = lambda s: math.neg(s)
Tensor.__abs__ = lambda s: math.abs(s)
Tensor.__matmul__ = lambda s, o: linalg.matmul(s, o)
Tensor.__rmatmul__ = _swap(linalg.matmul)
Tensor.__eq__ = lambda s, o: logic.equal(s, o)
Tensor.__ne__ = lambda s, o: logic.not_equal(s, o)
Tensor.__lt__ = lambda s, o: logic.less_than(s, o)
Tensor.__le__ = lambda s, o: logic.less_equal(s, o)
Tensor.__gt__ = lambda s, o: logic.greater_than(s, o)
Tensor.__ge__ = lambda s, o: logic.greater_equal(s, o)
Tensor.__and__ = lambda s, o: logic.bitwise_and(s, o)
Tensor.__or__ = lambda s, o: logic.bitwise_or(s, o)
Tensor.__xor__ = lambda s, o: logic.bitwise_xor(s, o)
Tensor.__invert__ = lambda s: logic.bitwise_not(s)
Tensor.__getitem__ = lambda s, item: manipulation.getitem(s, item)
Tensor.__setitem__ = manipulation._setitem


# --------------------------------------------------------------------------
# Method attachment (the reference's monkey_patch_tensor)
# --------------------------------------------------------------------------
_METHODS = {
    # math
    "abs": math.abs, "acos": math.acos, "asin": math.asin, "atan": math.atan,
    "ceil": math.ceil, "cos": math.cos, "cosh": math.cosh, "exp": math.exp,
    "floor": math.floor, "log": math.log, "log2": math.log2,
    "log10": math.log10, "log1p": math.log1p, "round": math.round,
    "rsqrt": math.rsqrt, "sigmoid": math.sigmoid, "sign": math.sign,
    "sin": math.sin, "sinh": math.sinh, "sqrt": math.sqrt,
    "square": math.square, "tan": math.tan, "tanh": math.tanh,
    "erf": math.erf, "expm1": math.expm1, "reciprocal": math.reciprocal,
    "trunc": math.trunc, "frac": math.frac, "lgamma": math.lgamma,
    "digamma": math.digamma, "neg": math.neg, "conj": math.conj,
    "angle": math.angle,
    "add": math.add, "subtract": math.subtract, "multiply": math.multiply,
    "divide": math.divide, "floor_divide": math.floor_divide,
    "mod": math.mod, "remainder": math.mod, "pow": math.pow,
    "maximum": math.maximum, "minimum": math.minimum,
    "fmax": math.fmax, "fmin": math.fmin, "atan2": math.atan2,
    "scale": math.scale, "clip": math.clip, "lerp": math.lerp,
    "addmm": math.addmm, "inner": math.inner, "outer": math.outer,
    "kron": math.kron, "trace": math.trace, "diagonal": math.diagonal,
    "sum": math.sum, "mean": math.mean, "max": math.max, "min": math.min,
    "prod": math.prod, "amax": math.amax, "amin": math.amin,
    "nansum": math.nansum, "nanmean": math.nanmean,
    "logsumexp": math.logsumexp, "all": math.all, "any": math.any,
    "std": math.std, "var": math.var, "median": math.median,
    "quantile": math.quantile, "cumsum": math.cumsum,
    "cumprod": math.cumprod, "cummax": math.cummax, "cummin": math.cummin,
    "logcumsumexp": math.logcumsumexp, "diff": math.diff,
    "isfinite": math.isfinite, "isinf": math.isinf, "isnan": math.isnan,
    "nan_to_num": math.nan_to_num, "count_nonzero": math.count_nonzero,
    "deg2rad": math.deg2rad, "rad2deg": math.rad2deg, "take": math.take,
    "increment": math.increment,
    # linalg
    "matmul": linalg.matmul, "mm": linalg.mm, "bmm": linalg.bmm,
    "dot": linalg.dot, "mv": linalg.mv, "norm": linalg.norm,
    "dist": linalg.dist, "cholesky": linalg.cholesky,
    "inverse": linalg.inverse, "pinv": linalg.pinv,
    "matrix_power": linalg.matrix_power, "cross": linalg.cross,
    "histogram": linalg.histogram,
    # logic
    "equal": logic.equal, "not_equal": logic.not_equal,
    "greater_than": logic.greater_than, "greater_equal": logic.greater_equal,
    "less_than": logic.less_than, "less_equal": logic.less_equal,
    "logical_and": logic.logical_and, "logical_or": logic.logical_or,
    "logical_xor": logic.logical_xor, "logical_not": logic.logical_not,
    "bitwise_and": logic.bitwise_and, "bitwise_or": logic.bitwise_or,
    "bitwise_xor": logic.bitwise_xor, "bitwise_not": logic.bitwise_not,
    "equal_all": logic.equal_all, "allclose": logic.allclose,
    "isclose": logic.isclose, "isin": logic.isin,
    # manipulation
    "reshape": manipulation.reshape, "transpose": manipulation.transpose,
    "moveaxis": manipulation.moveaxis, "flatten": manipulation.flatten,
    "squeeze": manipulation.squeeze, "unsqueeze": manipulation.unsqueeze,
    "concat": manipulation.concat, "split": manipulation.split,
    "chunk": manipulation.chunk, "tile": manipulation.tile,
    "expand": manipulation.expand, "expand_as": manipulation.expand_as,
    "broadcast_to": manipulation.broadcast_to, "flip": manipulation.flip,
    "roll": manipulation.roll, "gather": manipulation.gather,
    "gather_nd": manipulation.gather_nd, "scatter": manipulation.scatter,
    "take_along_axis": manipulation.take_along_axis,
    "put_along_axis": manipulation.put_along_axis,
    "index_select": manipulation.index_select,
    "index_add": manipulation.index_add, "index_fill": manipulation.index_fill,
    "masked_select": manipulation.masked_select,
    "masked_fill": manipulation.masked_fill,
    "unbind": manipulation.unbind, "unstack": manipulation.unstack,
    "tril": creation.tril, "triu": creation.triu, "diag": creation.diag,
    "repeat_interleave": manipulation.repeat_interleave,
    "unique": manipulation.unique, "nonzero": manipulation.nonzero,
    "pad": manipulation.pad, "swapaxes": manipulation.swapaxes,
    "unfold": manipulation.unfold, "view": manipulation.view,
    "as_real": manipulation.as_real, "as_complex": manipulation.as_complex,
    "bincount": manipulation.bincount,
    "tensordot": manipulation.tensordot,
    "unflatten": manipulation.unflatten, "vsplit": manipulation.vsplit,
    "hsplit": manipulation.hsplit, "dsplit": manipulation.dsplit,
    "diagonal_scatter": manipulation.diagonal_scatter,
    "select_scatter": manipulation.select_scatter,
    "as_strided": manipulation.as_strided,
    "fill_diagonal_tensor": manipulation.fill_diagonal_tensor,
    "index_put": manipulation.index_put, "t": manipulation.t,
    "stack": manipulation.stack, "slice": manipulation.slice,
    "strided_slice": manipulation.strided_slice,
    "scatter_nd": manipulation.scatter_nd,
    "scatter_nd_add": manipulation.scatter_nd_add,
    "shard_index": manipulation.shard_index, "rot90": manipulation.rot90,
    "unique_consecutive": manipulation.unique_consecutive,
    "broadcast_tensors": manipulation.broadcast_tensors,
    "reverse": manipulation.flip,
    # search
    "argmax": search.argmax, "argmin": search.argmin,
    "argsort": search.argsort, "sort": search.sort, "topk": search.topk,
    "kthvalue": search.kthvalue, "mode": search.mode,
    "searchsorted": search.searchsorted, "bucketize": search.bucketize,
    "index_sample": search.index_sample,
    # random
    "normal_": random_ops.normal_, "uniform_": random_ops.uniform_,
    "exponential_": random_ops.exponential_,
    "multinomial": random_ops.multinomial, "bernoulli": random_ops.bernoulli,
    # creation
    "ones_like": creation.ones_like, "zeros_like": creation.zeros_like,
    "full_like": creation.full_like,
    # math tail
    "logit": math.logit, "sgn": math.sgn, "trapezoid": math.trapezoid,
    "cumulative_trapezoid": math.cumulative_trapezoid,
    "vander": math.vander, "nanquantile": math.nanquantile,
    "signbit": math.signbit, "sinc": math.sinc, "isreal": math.isreal,
    "nanargmax": math.nanargmax, "nanargmin": math.nanargmin,
    "bitwise_left_shift": math.bitwise_left_shift,
    "bitwise_right_shift": math.bitwise_right_shift,
    "acosh": math.acosh, "asinh": math.asinh, "atanh": math.atanh,
    "add_n": math.add_n, "erfinv": math.erfinv, "floor_mod": math.mod,
    "frexp": math.frexp, "gcd": math.gcd, "lcm": math.lcm,
    "heaviside": math.heaviside, "i0": math.i0, "i0e": math.i0e,
    "i1": math.i1, "i1e": math.i1e, "imag": math.imag, "real": math.real,
    "logaddexp": math.logaddexp, "multiplex": math.multiplex,
    "nanmedian": math.nanmedian, "nextafter": math.nextafter,
    "stanh": math.stanh, "broadcast_shape": math.broadcast_shape,
    # linalg tail
    "cdist": linalg.cdist, "pdist": linalg.pdist,
    "lu_solve": linalg.lu_solve, "logdet": linalg.logdet,
    "vecdot": linalg.vecdot, "baddbmm": linalg.baddbmm,
    "cholesky_inverse": linalg.cholesky_inverse,
    "cholesky_solve": linalg.cholesky_solve, "cond": linalg.cond,
    "corrcoef": linalg.corrcoef, "cov": linalg.cov, "eig": linalg.eig,
    "eigvals": linalg.eigvals, "eigvalsh": linalg.eigvalsh,
    "lstsq": linalg.lstsq, "lu": linalg.lu, "lu_unpack": linalg.lu_unpack,
    "multi_dot": linalg.multi_dot, "qr": linalg.qr, "solve": linalg.solve,
    "triangular_solve": linalg.triangular_solve,
    # attribute / logic tail
    "rank": attribute.rank, "is_complex": attribute.is_complex,
    "is_floating_point": attribute.is_floating_point,
    "is_integer": attribute.is_integer, "is_empty": logic.is_empty,
    "is_tensor": logic.is_tensor,
    "create_parameter": creation.create_parameter,
    "create_tensor": creation.create_tensor, "polar": creation.polar,
}

for _name, _fn in _METHODS.items():
    if not hasattr(Tensor, _name):
        setattr(Tensor, _name, _fn)


def _where_method(self, x=None, y=None):
    return manipulation.where(self, x, y)


Tensor.where = _where_method


def _make_inplace(fn):
    """An in-place variant ``f_(x, ...)``: computes out of place and rebinds
    ``x`` (so gradients flow through it, as the reference's tape
    rebinding)."""
    def inplace(x, *args, **kwargs):
        return rebind_inplace(x, fn(x, *args, **kwargs))
    return inplace


add_ = _make_inplace(math.add)
subtract_ = _make_inplace(math.subtract)
multiply_ = _make_inplace(math.multiply)
divide_ = _make_inplace(_div)
scale_ = _make_inplace(math.scale)
clip_ = _make_inplace(math.clip)
remainder_ = _make_inplace(math.mod)
mod_ = remainder_
floor_divide_ = _make_inplace(math.floor_divide)
pow_ = _make_inplace(math.pow)
tanh_ = _make_inplace(math.tanh)
erfinv_ = _make_inplace(math.erfinv)
lerp_ = _make_inplace(math.lerp)
logit_ = _make_inplace(math.logit)
exp_ = _make_inplace(math.exp)
sqrt_ = _make_inplace(math.sqrt)
rsqrt_ = _make_inplace(math.rsqrt)
reciprocal_ = _make_inplace(math.reciprocal)
round_ = _make_inplace(math.round)
floor_ = _make_inplace(math.floor)
ceil_ = _make_inplace(math.ceil)
neg_ = _make_inplace(math.neg)
abs_ = _make_inplace(math.abs)
sigmoid_ = _make_inplace(math.sigmoid)
reshape_ = _make_inplace(manipulation.reshape)
flatten_ = _make_inplace(manipulation.flatten)
squeeze_ = _make_inplace(manipulation.squeeze)
unsqueeze_ = _make_inplace(manipulation.unsqueeze)
scatter_ = _make_inplace(manipulation.scatter)
index_add_ = _make_inplace(manipulation.index_add)
index_put_ = _make_inplace(manipulation.index_put)
put_along_axis_ = _make_inplace(manipulation.put_along_axis)
index_fill_ = _make_inplace(manipulation.index_fill)
fill_diagonal_ = _make_inplace(manipulation.fill_diagonal)
fill_diagonal_tensor_ = _make_inplace(manipulation.fill_diagonal_tensor)
masked_scatter_ = _make_inplace(manipulation.masked_scatter)
masked_fill_ = _make_inplace(manipulation.masked_fill)
uniform_ = random_ops.uniform_


def where_(condition, x, y, name=None):
    """In-place where: writes the selection into ``x``."""
    return rebind_inplace(x, manipulation.where(condition, x, y))


def _fill_(x, value):
    return random_ops._fill(x, torch.full_like(x._value, value))


def fill_(x, value, name=None):
    return _fill_(x, value)


def zero_(x, name=None):
    return _fill_(x, 0)


def tolist(x):
    """Nested Python list of the tensor's values."""
    return x.numpy().tolist()


Tensor.fill_ = _fill_
Tensor.zero_ = lambda x: _fill_(x, 0)
Tensor.tolist = tolist
for _n2 in ("add_", "subtract_", "multiply_", "scale_", "clip_",
            "remainder_", "mod_", "floor_divide_", "pow_", "tanh_",
            "erfinv_", "lerp_", "logit_", "exp_", "sqrt_", "rsqrt_",
            "reciprocal_", "round_", "floor_", "ceil_", "neg_", "abs_",
            "sigmoid_", "reshape_", "flatten_", "squeeze_", "unsqueeze_",
            "scatter_", "index_add_", "index_put_", "put_along_axis_",
            "index_fill_", "fill_diagonal_", "fill_diagonal_tensor_",
            "masked_scatter_", "masked_fill_", "divide_"):
    setattr(Tensor, _n2, globals()[_n2])
Tensor.__iadd__ = add_
Tensor.__isub__ = subtract_
Tensor.__imul__ = multiply_
Tensor.__itruediv__ = divide_

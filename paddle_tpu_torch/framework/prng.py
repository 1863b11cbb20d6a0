"""JAX's default PRNG (threefry2x32) in PyTorch, bit for bit.

Port of what jax 0.9 computes for ``jax.random.PRNGKey``, ``split``,
``fold_in``, ``bits`` (uint32), ``uniform`` and ``normal`` (float32) and
``categorical`` (gumbel-max, ``mode="low"``) with
``jax_threefry_partitionable`` on (its default): counters are the 64-bit
flat index of each element, split into (hi, lo) words, and a 32-bit draw
is the XOR of the two output words. A draw's element depends only on its
flat index, so ``offset=`` draws a slice of a larger draw: the elements
at flat indices ``[offset, offset + prod(shape))``.

A host key is a pair of Python ints ``(k0, k1)``, each a uint32 value,
so ``split`` and ``fold_in`` of a host key run on the host and launch
nothing. ``bits``, ``uniform`` and ``categorical`` over a tensor shape run
on a device; there threefry is a chain of stock integer ops on int64
tensors holding uint32 values (torch's uint32 has no arithmetic on the CPU
or CUDA), about 150 elementwise launches for one draw. ``>>`` stays
logical because every value is kept in [0, 2**32).

Keys on the device: a tensor key is an int64 tensor ``[..., 2]`` of
uint32 words, one key per leading index. Every one-key call also takes a
tensor key ``[2]`` and then reads no word of it on the host: ``split``
returns the ``[num, 2]`` tensor of subkeys, and ``bits``/``uniform``/
``categorical`` draw over the whole shape from it, bit for bit the draw of
the host pair holding the same words. That is the form a captured CUDA
graph needs: a host pair's words would be baked into the graph as
constants, and every replay would draw the same numbers.
:func:`fold_in_rows` folds a tensor of data (or a Python int) into tensor
keys (or into a host key), and :func:`uniform_rows` /
:func:`categorical_rows` draw with one key per leading row, each row equal
to ``jax.vmap`` of the one-key call: the counters run 0.. within every
row. One threefry over all rows draws for all of them, so a batch of keys
costs what one key costs.
"""
from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from ..device import resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def _key_words(key):
    """``(k0, k1)`` of a host pair (Python ints) or of a tensor key
    ``[..., 2]`` (int64 tensors of shape ``[...]``)."""
    if torch.is_tensor(key):
        return key[..., 0], key[..., 1]
    return int(key[0]) & MASK, int(key[1]) & MASK


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block (20 rounds) of ``key`` over the counter
    words ``(x0, x1)``. ``key`` is a host pair or a tensor key ``[...,
    2]``; the words are Python ints or int64 tensors holding uint32 values
    (broadcast together with the key's words); so is the result pair."""
    k0, k1 = _key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed as a
    32-bit integer, so ``(0, seed mod 2**32)`` (``PRNGKey(-1)`` is
    ``(0, 0xffffffff)``)."""
    return (0, int(seed) & MASK)


def fold_in(key, data) -> tuple[int, int]:
    """``jax.random.fold_in``: threefry of ``key`` over the counter
    ``(0, uint32(data))``; data outside uint32 raises, as in jax."""
    d = int(data)
    if not 0 <= d <= MASK:
        raise OverflowError(f"fold_in data {d} is out of bounds for uint32")
    return threefry2x32(key, 0, d)


def split(key, num: int = 2):
    """``jax.random.split`` (partitionable form): key i is threefry of
    ``key`` over the counter ``(i >> 32, i & 0xffffffff)``. A host pair
    gives a list of host pairs; a tensor key ``[..., 2]`` gives the int64
    tensor ``[..., num, 2]`` on its device, computed there."""
    if not torch.is_tensor(key):
        return [threefry2x32(key, i >> 32, i & MASK)
                for i in range(int(num))]
    i = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], i >> 32, i & MASK)
    return torch.stack([y0, y1], dim=-1)


def fold_in_rows(keys, data) -> torch.Tensor:
    """``jax.vmap(jax.random.fold_in)`` over tensors: ``keys`` a tensor key
    ``[..., 2]`` or a host pair, ``data`` an integer tensor broadcast
    against the keys' leading shape, or a Python int folded into every
    tensor key (no tensor is made of it, so nothing is copied to the
    device). Data wraps to uint32 as jax's conversion of an int32 array
    does (-1 folds in 0xffffffff). Returns int64 keys ``[..., 2]`` on
    data's device (an int's: the keys')."""
    if isinstance(data, numbers.Integral):
        if not torch.is_tensor(keys):
            raise TypeError("fold_in_rows of a host key needs tensor data "
                            "(fold_in folds an int into a host key)")
        d, dev = int(data) & MASK, keys.device
    else:
        d = torch.as_tensor(data).long() & MASK
        dev = d.device
    y0, y1 = threefry2x32(keys, 0, d)
    y0, y1 = torch.broadcast_tensors(torch.as_tensor(y0, device=dev),
                                     torch.as_tensor(y1, device=dev))
    return torch.stack([y0, y1], dim=-1)


def _uniform_from_bits(b, minval, maxval) -> torch.Tensor:
    """float32 uniforms from uint32 draws held in int64 (see
    :func:`uniform`)."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = float(np.float32(hi - lo))
    if scale == 1.0 and lo == 0.0:      # the common case: exact as it is
        return f
    out = (f.double() * scale + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def _bits_rows(keys, n: int) -> torch.Tensor:
    """``bits(key_r, (n,))`` for every key of ``keys [..., 2]``: int64
    ``[..., n]``, counters 0..n-1 in each row."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    if n > MASK + 1:
        hi, lo = idx >> 32, idx & MASK
    else:
        hi, lo = 0, idx
    y0, y1 = threefry2x32(keys[..., None, :], hi, lo)
    return y0 ^ y1


def uniform_rows(keys, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, shape, float32, minval,
    maxval))`` over a tensor key ``[..., 2]``: float32 ``[..., *shape]``
    on the keys' device, every row drawn at counters 0.. of its own
    key."""
    shape = _shape(shape)
    b = _bits_rows(keys, math.prod(shape))
    return _uniform_from_bits(b, minval, maxval).reshape(
        tuple(keys.shape[:-1]) + shape)


def categorical_rows(keys, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)`` over a tensor key ``[..., 2]``
    and logits ``[..., V]`` (float32): row r is the argmax of its logits
    plus gumbel noise drawn from its own key over ``(V,)``. Returns int64
    ``[...]``."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical draws float32 gumbel noise; got "
                         f"{logits.dtype} logits")
    u = uniform_rows(keys, (logits.shape[-1],), _F32_TINY, 1.0)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits, dim=-1)


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _bits64(key, shape, device, offset=0) -> torch.Tensor:
    """``bits`` as an int64 tensor of uint32 values on ``device``, at the
    flat indices ``offset`` onward."""
    shape = _shape(shape)
    n = math.prod(shape)
    offset = int(offset)
    if offset < 0:
        raise ValueError(f"counter offset must be >= 0, got {offset}")
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    if offset + n > MASK + 1:
        hi, lo = idx >> 32, idx & MASK
    else:   # high words all 0: a Python int broadcasts and spares launches
        hi, lo = 0, idx
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


def _bits_host(key) -> int:
    """``bits(key, ())`` as a Python int, computed on the host (no tensor
    ops): the draw of a scalar seed."""
    y0, y1 = threefry2x32(key, 0, 0)
    return y0 ^ y1


def bits(key, shape=(), device=None, offset=0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: a torch.uint32 tensor on
    ``device`` (default the CUDA card); ``key``: a host pair or a tensor
    key ``[2]`` on that device; ``offset``: see the module doc."""
    return _bits64(key, shape, resolve_device(device), offset).to(
        torch.uint32)


def uniform(key, shape=(), minval=0.0, maxval=1.0, device=None,
            offset=0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits of each draw as the mantissa of a float in [1, 2), minus
    1, scaled and shifted, then floored at ``minval``; on ``device``
    (default the CUDA card), from a host pair or a tensor key ``[2]``.

    XLA contracts the scale-and-shift into one fused multiply-add; here
    it is formed in float64 (the product of two float32 values is exact
    there) and rounded to float32 once, which gives XLA's bits.
    ``offset``: see the module doc."""
    return _uniform_from_bits(_bits64(key, shape, resolve_device(device),
                                      offset), minval, maxval)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as the fused multiply-add XLA's
    CPU code contracts ``a * b + c`` into. Formed from IEEE float64 adds
    and multiplies, which round alike on every device: the product of two
    float32 values is exact in float64, and the float64 sum, rounded to
    float32, is the fused result unless it landed exactly on a float32
    rounding midpoint (or below float32's normal range). Only then is
    the sum's error (exact by TwoSum) needed: it moves the sum one
    float64 step toward the exact value, off the midpoint."""
    p = a.double() * b
    s = p + c
    si = s.view(torch.int64)
    suspect = ((si & 0x1FFFFFFF) == 0x10000000) | (s.abs() < _F32_TINY)
    if bool(suspect.any()):
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        step = torch.sign(err * s).long()
        si = torch.where(suspect, si + step, si)
        s = si.view(torch.float64)
    return s.float()


def _f32(x: float) -> float:
    return float(np.float32(x))


# XLA's f32 logf (Cephes): mantissa polynomial, in the pairs its CPU code
# evaluates together
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, -1.2420140846e-1, 1.4249322787e-1,
    2.0000714765e-1, -2.4999993993e-1, 1.1676998740e-1, -1.6668057665e-1,
    3.3333331174e-1))
_SQRTHF = _f32(0.707106781186547524)
# XLA's log1p below sqrt(2) - 1: Cephes' rational approximation
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
# XLA's f32 erf_inv (Giles): coefficients for w < 5 and w >= 5
_ERFINV_LT5 = tuple(_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU, for finite y > 0 (the only inputs
    :func:`_log1p_f32` gives it): y = m 2^e with m in [sqrt(1/2),
    sqrt(2)), a degree-8 polynomial in m - 1, and e ln 2 added in two
    parts."""
    y = torch.clamp_min(y, _F32_TINY)
    b = y.view(torch.int32)
    e = ((b >> 23) - 127).float() + 1.0
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRTHF
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    x2 = x * x
    x3 = x2 * x
    c = _LOG_P
    pa = _fma32(_fma32(x, c[0], c[1]), x, c[6])
    pb = _fma32(_fma32(x, c[2], c[3]), x, c[7])
    pc = _fma32(_fma32(x, c[4], c[5]), x, c[8])
    r = _fma32(_fma32(pa, x3, pb), x3, pc)
    r = _fma32(r, x3, e * _f32(-2.12194440e-4))
    t = _fma32(x2, -0.5, x)
    return _fma32(e, 0.693359375, t + r)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` on the CPU, for x in (-1, 0]: ``log(1 +
    x)`` where |x| >= sqrt(2) - 1, else ``x - x^2/2 + x^3 P(x)/Q(x)``."""
    num = torch.full_like(x, _LOG1P_NUM[0])
    den = torch.ones_like(x)
    for cn, cd in zip(_LOG1P_NUM[1:], _LOG1P_DEN[1:]):
        num = _fma32(num, x, cn)
        den = _fma32(den, x, cd)
    x2 = x * x
    small = x + _fma32(x2, -0.5, (x * x2) * (num / den))
    large = _log_f32(x + 1.0)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, large)


def _erf_inv_f32(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' single-precision polynomials in
    ``w = -log1p(-u^2)``), for u in (-1, 1)."""
    w = -_log1p_f32(u * -u)
    lt5 = w < 5.0
    # sqrt in float64, rounded once: float32's correctly rounded sqrt
    w = torch.where(lt5, w - 2.5, w.double().sqrt().float() - 3.0)
    p = torch.where(lt5, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, torch.where(lt5, a, b))
    return p * u


def normal(key, shape=(), dtype=torch.float32, device=None,
           offset=0) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``, bit for bit: ``sqrt(2)
    * erf_inv(u)`` with u uniform over [nextafter(-1, 0), 1), through
    XLA's own float32 ``erf_inv`` and ``log1p`` (``torch.erfinv`` and
    ``torch.log1p`` give other bits), on ``device`` (default the CUDA
    card); cast to ``dtype`` last. Only IEEE adds, multiplies, divides
    and square roots, so the card and the CPU give the same bits.
    ``offset``: see the module doc."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device, offset=offset)
    return (_erf_inv_f32(u) * _f32(math.sqrt(2.0))).to(dtype)


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the argmax of
    ``logits`` plus gumbel noise ``-log(-log(u))``, u uniform over
    [tiny, 1) in float32, drawn over the logits' whole shape from a host
    pair or a tensor key ``[2]`` on the logits' device. Returns int64
    indices with ``axis`` removed."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical draws float32 gumbel noise; got "
                         f"{logits.dtype} logits")
    u = uniform(key, logits.shape, _F32_TINY, 1.0, device=logits.device)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits, dim=axis)

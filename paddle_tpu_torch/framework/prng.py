"""JAX's default PRNG (threefry2x32) in PyTorch, bit for bit.

Port of what jax 0.9 computes for ``jax.random.PRNGKey``, ``split``,
``fold_in``, ``bits`` (uint32), ``uniform`` (float32) and ``categorical``
(gumbel-max, ``mode="low"``) with ``jax_threefry_partitionable`` on (its
default): counters are the 64-bit flat index of each element, split into
(hi, lo) words, and a 32-bit draw is the XOR of the two output words.

A key is a pair of Python ints ``(k0, k1)``, each a uint32 value, so
``split`` and ``fold_in`` run on the host and launch nothing. Only
``bits``, ``uniform`` and ``categorical`` over a tensor shape run on a
device; there threefry is a chain of stock integer ops on int64 tensors
holding uint32 values (torch's uint32 has no arithmetic on the CPU or
CUDA), about 150 elementwise launches for one draw. ``>>`` stays logical
because every value is kept in [0, 2**32).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block (20 rounds) of ``key = (k0, k1)`` over the
    counter words ``(x0, x1)``. The words are Python ints or int64
    tensors holding uint32 values (broadcast together); so is the result
    pair."""
    k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
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


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` (partitionable form): key i is threefry of
    ``key`` over the counter ``(i >> 32, i & 0xffffffff)``."""
    return [threefry2x32(key, i >> 32, i & MASK) for i in range(int(num))]


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _bits64(key, shape, device) -> torch.Tensor:
    """``bits`` as an int64 tensor of uint32 values on ``device``."""
    shape = _shape(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if n > MASK + 1:
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


def bits(key, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: a torch.uint32 tensor on
    ``device`` (default the CUDA card)."""
    return _bits64(key, shape, resolve_device(device)).to(torch.uint32)


def uniform(key, shape=(), minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits of each draw as the mantissa of a float in [1, 2), minus
    1, scaled and shifted, then floored at ``minval``; on ``device``
    (default the CUDA card).

    XLA contracts the scale-and-shift into one fused multiply-add; here
    it is formed in float64 (the product of two float32 values is exact
    there) and rounded to float32 once, which gives XLA's bits."""
    b = _bits64(key, shape, resolve_device(device))
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = float(np.float32(hi - lo))
    if scale == 1.0 and lo == 0.0:      # the common case: exact as it is
        return f
    out = (f.double() * scale + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the argmax of
    ``logits`` plus gumbel noise ``-log(-log(u))``, u uniform over
    [tiny, 1) in float32, drawn over the logits' whole shape. Returns
    int64 indices with ``axis`` removed."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical draws float32 gumbel noise; got "
                         f"{logits.dtype} logits")
    u = uniform(key, logits.shape, _F32_TINY, 1.0, device=logits.device)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits, dim=axis)

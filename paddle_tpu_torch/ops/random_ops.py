"""Random ops: port of paddle_tpu/ops/random_ops.py (reference:
python/paddle/tensor/random.py). Keys come from
``framework.random.next_key()`` and draws from ``framework.prng``, jax's
threefry ported bit for bit, so after ``seed(s)`` the float32 draws of
``rand``, ``uniform``, ``randn``, ``normal``, ``gaussian``, ``randint``,
``randperm``, ``bernoulli``, ``multinomial`` and the in-place fills equal
the reference's. ``poisson``, ``binomial`` and ``standard_gamma`` (jax's
rejection samplers) draw with torch's samplers from a generator seeded by
the key: seeded and repeatable, not the reference's numbers."""
from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..framework import prng
from ..framework import random as _random
from ..framework.dtype import get_default_dtype, to_torch
from ..framework.place import current_device
from ..tensor import Tensor, _val, unwrap

MASK = prng.MASK


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _key(seed=0):
    return prng.PRNGKey(seed) if seed else _random.next_key()


def _uniform(key, shape, dtype, minval=0.0, maxval=1.0, device=None):
    return prng.uniform(key, shape, minval, maxval,
                        device=device or current_device()).to(
        to_torch(dtype or get_default_dtype()))


def _normal(key, shape, dtype=None, device=None):
    return prng.normal(key, shape, to_torch(dtype or get_default_dtype()),
                       device=device or current_device())


def rand(shape, dtype=None, name=None):
    return Tensor(_uniform(_random.next_key(), _shape(shape), dtype))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    return Tensor(_uniform(_key(seed), _shape(shape), dtype, min, max))


def randn(shape, dtype=None, name=None):
    return Tensor(_normal(_random.next_key(), _shape(shape), dtype))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = _val(mean), _val(std)
        shp = torch.broadcast_shapes(tuple(np.shape(m)), tuple(np.shape(s)))
        dev = (m if isinstance(m, torch.Tensor) else s).device
        return Tensor(_normal(_random.next_key(), shp, "float32", dev) * s
                      + m)
    return Tensor(_normal(_random.next_key(), _shape(shape or [1])) * std
                  + mean)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    return Tensor(_normal(_key(seed), _shape(shape), dtype) * std + mean)


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def _randint_values(key, shape, low, high, device):
    """``jax.random.randint`` for 32-bit ints: two uint32 draws from the
    halves of ``split(key)``, combined modulo the span with uint32
    wraparound."""
    k1, k2 = prng.split(key, 2)
    hi = prng._bits64(k1, shape, device)
    lo = prng._bits64(k2, shape, device)
    span = (high - low) & MASK if high > low else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    off = ((((hi % span) * mult) & MASK) + (lo % span)) & MASK
    return (off % span) + low


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    v = _randint_values(_random.next_key(), _shape(shape), int(low),
                        int(high), current_device())
    return Tensor(v.to(to_torch(dtype)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, x.shape, dtype or x.dtype)


def _shuffle(key, x):
    """``jax.random.permutation``'s shuffle: ceil(3 ln n / ln(2^32 - 1))
    rounds, each sorting by fresh uint32 keys."""
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    for _ in range(rounds):
        key, sub = prng.split(key, 2)
        order = torch.argsort(prng._bits64(sub, (n,), x.device), stable=True)
        x = x[order]
    return x


def randperm(n, dtype="int64", name=None):
    x = torch.arange(int(n), device=current_device())
    return Tensor(_shuffle(_random.next_key(), x).to(to_torch(dtype)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    key = _random.next_key()
    probs = _val(x)
    logits = torch.log(torch.clamp_min(probs.float(), 1e-30))
    n = int(num_samples)
    if replacement:
        g = prng.gumbel(key, (n,) + tuple(logits.shape), device=probs.device)
        samples = torch.argmax(g + logits, -1).movedim(0, -1)
    else:
        # Gumbel top-k gives sampling without replacement
        g = prng.gumbel(key, tuple(logits.shape), device=probs.device)
        samples = torch.topk(logits + g, n, -1).indices
    return Tensor(samples.to(torch.int32))


def bernoulli(x, name=None):
    p = _val(x)
    u = prng.uniform(_random.next_key(), tuple(p.shape), device=p.device)
    return Tensor((u < p).to(p.dtype))


def _torch_generator(key, device):
    g = torch.Generator(device=device)
    g.manual_seed(prng._bits_host(key))
    return g


def poisson(x, name=None):
    v = _val(x)
    g = _torch_generator(_random.next_key(), v.device)
    return Tensor(torch.poisson(v, generator=g))


def binomial(count, prob, name=None):
    c, p = _val(count), _val(prob)
    dev = (c if isinstance(c, torch.Tensor) else p).device
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    g = _torch_generator(_random.next_key(), dev)
    return Tensor(torch.binomial(c, p, generator=g).to(torch.int32))


def rand_like(x, dtype=None, name=None):
    return rand(x.shape, dtype or x.dtype)


def randn_like(x, dtype=None, name=None):
    return randn(x.shape, dtype or x.dtype)


def _fill(x, value):
    """Write a draw into ``x`` outside autograd (the reference rebinds the
    value and drops its producer)."""
    v = value.to(x._value.dtype)
    if isinstance(x._value, torch.nn.Parameter):
        with torch.no_grad():
            x._value.copy_(v)
    else:
        x._value = v
        x.stop_gradient = x.stop_gradient   # a new leaf keeps its flag
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    v = _val(x)
    return _fill(x, prng.normal(_random.next_key(), tuple(v.shape),
                                device=v.device) * std + mean)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    v = _val(x)
    return _fill(x, prng.uniform(_key(seed), tuple(v.shape), min, max,
                                 device=v.device))


def exponential_(x, lam=1.0, name=None):
    v = _val(x)
    u = prng.uniform(_random.next_key(), tuple(v.shape), device=v.device)
    return _fill(x, -prng._log1p_f32(-u) / lam)


def uniform_random_batch_size_like(input, shape, input_dim_idx=0,
                                   output_dim_idx=0, min=-1.0, max=1.0,
                                   seed=0, dtype="float32", name=None):
    """Uniform sample whose output_dim_idx-th dim copies input's
    input_dim_idx-th dim."""
    shape = list(shape)
    shape[output_dim_idx] = unwrap(input).shape[input_dim_idx]
    return uniform(shape, dtype=dtype, min=min, max=max, seed=seed)


def standard_gamma(x, name=None):
    """Gamma(alpha=x, 1) elementwise."""
    v = _val(x)
    g = _torch_generator(_random.next_key(), v.device)
    return Tensor(torch._standard_gamma(v, generator=g))


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    s = _shape(shape) if shape is not None else ()
    z = prng.normal(_random.next_key(), s, device=current_device())
    return Tensor(prng.exp_f32(z * std + mean))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    v = _val(x)
    z = prng.normal(_random.next_key(), tuple(v.shape), device=v.device)
    return _fill(x, prng.exp_f32(z * std + mean))


def bernoulli_(x, p=0.5, name=None):
    v = _val(x)
    u = prng.uniform(_random.next_key(), tuple(v.shape), device=v.device)
    return _fill(x, (u < p).float())


def cauchy_(x, loc=0, scale=1, name=None):
    v = _val(x)
    u = prng.uniform(_random.next_key(), tuple(v.shape),
                     float(np.finfo(np.float32).eps), 1.0, device=v.device)
    return _fill(x, loc + scale * torch.tan(_math.pi * (u - 0.5)))


def geometric_(x, probs, name=None):
    v = _val(x)
    u = prng.uniform(_random.next_key(), tuple(v.shape), device=v.device)
    return _fill(x, torch.floor(torch.log1p(-u) / _math.log1p(-probs)) + 1.0)

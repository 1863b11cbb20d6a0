"""Fused bias + dropout + residual add + LayerNorm: the CUDA kernel
``csrc/fused_residual_ln.cu`` and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/fused_residual_ln.py:
``y = LayerNorm(residual + dropout(x + bias))`` over [N, D] rows, all math
in f32, y in x's dtype. The dropout mask is the reference's counter hash
of (seed, global row, column), equal bit for bit on the CPU and the card:
the plain version computes it in int64 with ``& 0xffffffff`` after every
product, the kernel in uint32 registers. The gradient, as in the
reference, has no kernel: backward runs autograd through the plain
version with the same mask.

The reference took its kernel only for ``D % 128 == 0`` and ``N >= 8``;
the kernels here take any N >= 1 and any D up to :data:`MAX_D`, and a
wider row raises. Two routes, chosen by shape before the launch
(:func:`fused_residual_ln_route`): ``warp`` (one warp a row, 16-byte
vectors, shuffle reductions; the keep test ``hash >= keep_threshold(p)``)
for rows of whole 16-byte chunks up to :data:`WARP_MAX_D` wide, ``block``
(one 256-thread block a row, scalar loads, the f32 keep test) for every
other width. Each launch is counted in ``.launches`` and ``.routes``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

MASK = 0xFFFFFFFF
BLOCK_THREADS = 256   # csrc/fused_residual_ln.cu: NT, the block route
MAX_D = BLOCK_THREADS * 32      # NT * MAX_VPT
WARP_ELEMS = 64       # WARP_MAX_ELEMS: f32 a lane holds on the warp route
WARP_MAX_D = 32 * WARP_ELEMS
ROUTES = ("block", "warp")      # the C entry's route numbers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_residual_ln_route(d: int, dtype, aligned: bool) -> str:
    """The kernel a CUDA call launches: ``warp`` where a row is whole
    16-byte chunks (D a multiple of 16 / itemsize), at most
    :data:`WARP_MAX_D` wide, and every operand 16-byte aligned
    (``aligned``), else ``block``."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return ("warp" if aligned and d % vec == 0 and d <= WARP_MAX_D
            else "block")


@functools.lru_cache(maxsize=64)
def keep_threshold(p: float) -> int:
    """The least uint32 ``t`` with ``rn_f32(t) * 2^-32 >= f32(p)``, or 2^32
    when none is. The map from a hash to its f32 uniform is monotone, so
    ``hash >= t`` keeps exactly the elements the reference's ``u >= p``
    keeps."""
    pf = np.float32(p)

    def kept(u):
        return np.float32(u) * np.float32(2.0 ** -32) >= pf

    if not kept(MASK):
        return MASK + 1
    lo, hi = 0, MASK      # kept(hi); t in [lo, hi]
    while lo < hi:
        mid = (lo + hi) // 2
        if kept(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def hash_uniform(seed: int, rows: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Port of ``_hash_uniform``: uniform [0, 1] f32 of [len(rows),
    n_cols] from (seed, row, col). int64 products keep their low 32 bits
    under ``& 0xffffffff`` (a wrapped int64 product has the same low
    bits), so rows of 2**16 and above wrap as uint32 does."""
    cols = torch.arange(n_cols, dtype=torch.int64, device=rows.device)
    r = rows.to(torch.int64)[:, None] & MASK
    x = ((r * 0x9E3779B9) & MASK) ^ ((cols * 0x85EBCA6B) & MASK)
    x = x ^ (int(seed) & MASK)
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & MASK
    x = ((x ^ (x >> 15)) * 0x846CA68B) & MASK
    x = x ^ (x >> 16)
    return x.to(torch.float32) / 2.0 ** 32


def _dropped(p: float) -> float:
    """f32 ``0 / f32(1 - p)``: +0, -0 (p > 1) or NaN (p = 1). The warp
    kernel multiplies a dropped element by it, which gives the reference's
    ``(h * 0) / (1 - p)`` bit for bit without a division."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float32(0.0) / np.float32(1.0 - p))


def _f32(value: float, device) -> torch.Tensor:
    """A 0-dim f32 operand (a fill, no host-to-device copy): on CUDA,
    ``t / 0.9`` would multiply by a rounded reciprocal, ``t / tensor(0.9)``
    divides."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def fused_bias_dropout_residual_ln_ref(x, bias, residual, gamma, beta,
                                       seed=0, p=0.0, eps=1e-5,
                                       training=False):
    """Plain version (the reference's ``_jnp_path``): x, residual [N, D];
    bias, gamma, beta [D]."""
    dev = x.device
    h = x.float() + bias.float()
    if training and p > 0.0:
        rows = torch.arange(h.shape[0], device=dev)
        u = hash_uniform(seed, rows, h.shape[1])
        keep = (u >= _f32(p, dev)).to(h.dtype)
        h = h * keep / _f32(1.0 - p, dev)
    h = h + residual.float()
    mu = h.mean(-1, keepdim=True)
    var = torch.square(h - mu).mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + _f32(eps, dev)) * gamma.float() \
        + beta.float()
    return out.to(x.dtype)


def _lib():
    fn = _build.load("fused_residual_ln").fused_residual_ln
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float, ctypes.c_ulonglong, ctypes.c_float,
                          ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel(x, bias, residual, gamma, beta, seed, p, eps, training):
    n, d = x.shape
    if x.dtype not in _DTYPES or residual.dtype != x.dtype:
        raise ValueError(f"fused_residual_ln kernel takes x and residual of "
                         f"one dtype in f32/bf16/f16; got {x.dtype}, "
                         f"{residual.dtype}")
    if d > MAX_D:
        raise ValueError(f"fused_residual_ln kernel takes rows up to "
                         f"{MAX_D} wide; got D={d}")
    if n > 0x7FFFFFFF:
        raise ValueError(f"fused_residual_ln kernel takes at most 2**31 - 1 "
                         f"rows; got {n}")
    x, residual = x.contiguous(), residual.contiguous()
    params = [t.to(torch.float32).contiguous() for t in (bias, gamma, beta)]
    if any(t.shape != (d,) or t.device != x.device
           for t in params) or residual.device != x.device:
        raise ValueError("fused_residual_ln: bias, gamma and beta must be [D] "
                         "and every operand on x's device")
    out = torch.empty_like(x)
    if n == 0:
        return out
    dropout = bool(training) and p > 0.0
    route = fused_residual_ln_route(d, x.dtype, all(
        t.data_ptr() % 16 == 0 for t in (x, residual, out, *params)))
    err = _lib()(x.data_ptr(), params[0].data_ptr(), residual.data_ptr(),
                 params[1].data_ptr(), params[2].data_ptr(), out.data_ptr(),
                 n, d, int(seed) & MASK, float(np.float32(p)),
                 keep_threshold(float(p)) if dropout else 0,
                 float(np.float32(1.0 - p)), _dropped(float(p)), float(eps),
                 int(dropout),
                 _DTYPES[x.dtype], ROUTES.index(route),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"fused_residual_ln ({route})")
    fused_bias_dropout_residual_ln.launches += 1
    fused_bias_dropout_residual_ln.routes[route] += 1
    return out


def _forward(x, bias, residual, gamma, beta, seed, p, eps, training):
    if x.device.type == "cpu":
        return fused_bias_dropout_residual_ln_ref(
            x, bias, residual, gamma, beta, seed, p, eps, training)
    if x.device.type == "cuda":
        return _kernel(x, bias, residual, gamma, beta, seed, p, eps,
                       training)
    raise ValueError(f"fused_bias_dropout_residual_ln: no kernel for "
                     f"{x.device}")


class _FusedResidualLN(torch.autograd.Function):
    """The kernel forward; backward recomputes through the plain version
    with the same seed, hence the same mask (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, x, bias, residual, gamma, beta, seed, p, eps, training):
        ctx.save_for_backward(x, bias, residual, gamma, beta)
        ctx.attrs = (seed, p, eps, training)
        return _forward(x, bias, residual, gamma, beta, seed, p, eps,
                        training)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:5])]
        with torch.enable_grad():
            out = fused_bias_dropout_residual_ln_ref(*inputs, *ctx.attrs)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,) * 4


def fused_bias_dropout_residual_ln(x, bias, residual, gamma, beta, p=0.0,
                                   eps=1e-5, training=False, seed=0):
    """x, residual: [N, D] (flatten leading dims first); bias, gamma,
    beta: [D]. Returns LayerNorm(residual + dropout(x + bias)) in x's
    dtype, differentiable. ``seed`` is a uint32 (a Python int, or a 0-dim
    tensor read once on the host). A CPU x runs the plain version; a CUDA
    x launches the kernel or raises."""
    if x.dim() != 2 or residual.shape != x.shape:
        raise ValueError(f"x and residual must be one [N, D] shape; got "
                         f"{tuple(x.shape)}, {tuple(residual.shape)}")
    return _FusedResidualLN.apply(x, bias, residual, gamma, beta,
                                  int(seed) & MASK, float(p), float(eps),
                                  bool(training))


fused_bias_dropout_residual_ln.launches = 0
fused_bias_dropout_residual_ln.routes = dict.fromkeys(ROUTES, 0)

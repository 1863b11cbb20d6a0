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
the kernel here takes any N >= 1 and any D up to :data:`MAX_D`, and a
wider row raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

MASK = 0xFFFFFFFF
MAX_D = 256 * 32      # csrc/fused_residual_ln.cu: NT * MAX_VPT
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
                          ctypes.c_float, ctypes.c_float, ctypes.c_float,
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
    err = _lib()(x.data_ptr(), params[0].data_ptr(), residual.data_ptr(),
                 params[1].data_ptr(), params[2].data_ptr(), out.data_ptr(),
                 n, d, int(seed) & MASK, float(np.float32(p)),
                 float(np.float32(1.0 - p)), float(eps), int(dropout),
                 _DTYPES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_residual_ln")
    fused_bias_dropout_residual_ln.launches += 1
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

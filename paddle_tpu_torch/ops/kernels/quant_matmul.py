"""Weight-only dequant-matmul: the CUDA kernel ``csrc/quant_matmul.cu``
and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/quant_matmul.py. ``quant_matmul(x, wq,
step, bits)`` computes ``x [M, K] @ dequant(wq) -> [M, N]`` f32, with
``wq`` int8 codes ``[K, N]`` (bits 8) or int4 codes packed two per byte
along K ``[K/2, N]`` (bits 4, ``gpt_quant.pack_int4`` layout) and ``step``
the f32 ``[N]`` per-output-column steps. The codes multiply in x's dtype
(int8 and int4 magnitudes are exact in bf16), the sum is f32, and the step
multiplies the sum once.

Three hand-written kernels, one chosen by shape before the launch
(:func:`quant_matmul_route`): the decode form ``skinny`` (CUDA-core FMAs,
M <= 8 or f32 x), the prefill form ``wgmma`` (bf16 x on the tensor cores,
tiles in by TMA, codes converted to bf16 in shared memory) and, for the
shapes TMA cannot map, ``wmma``. Each launch is counted in
``quant_matmul.launches`` and in ``quant_matmul.routes``.
"""
from __future__ import annotations

import ctypes

import torch

from ...quantization.gpt_quant import unpack_int4
from . import _build
from .primitives import f32_mm

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("skinny", "wmma", "wgmma")     # the C entry's route numbers


def quant_matmul_route(M: int, K: int, N: int, bits: int, x_dtype,
                       aligned: bool) -> str:
    """The kernel a CUDA call of :func:`quant_matmul` launches: ``skinny``
    for f32 x or M <= 8 (decode: bound by the code bytes), else ``wgmma``
    where TMA can map x [M, K] bf16 and the codes [K or K/2, N] int8 (16-byte
    row strides, N % 16 == 0 and K % 8 == 0; ``aligned``: both base
    pointers 16-byte aligned), else ``wmma``. ``bits`` does not change the
    rule: int4's packed rows keep the codes' N-byte stride and halve K's."""
    if bits not in (4, 8):
        raise ValueError(f"quant_matmul supports bits in (4, 8), got {bits}")
    if x_dtype != torch.bfloat16 or M <= 8:
        return "skinny"
    if aligned and N % 16 == 0 and K % 8 == 0:
        return "wgmma"
    return "wmma"


def quant_matmul_ref(x, wq, step, bits: int = 8):
    """The plain version, port of the reference's fallback: unpack (int4,
    packed row r holding rows 2r and 2r + 1), cast the codes to x's dtype,
    product with f32 accumulation (:func:`~.primitives.f32_mm`), then
    ``* step``."""
    w = unpack_int4(wq, axis=0) if bits == 4 else wq
    return f32_mm(x, w.to(x.dtype)) * step


def _lib():
    fn = _build.load("quant_matmul").quant_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(x, wq, step, bits):
    if bits not in (4, 8):
        raise ValueError(f"quant_matmul supports bits in (4, 8), got {bits}")
    if x.dim() != 2 or wq.dim() != 2 or step.dim() != 1:
        raise ValueError(f"quant_matmul wants x [M, K], codes 2-D, step "
                         f"[N]; got {tuple(x.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(step.shape)}")
    M, K = x.shape
    if bits == 4 and K % 2:
        raise ValueError(f"int4 codes pack K in pairs: K={K} must be even")
    rows = K // 2 if bits == 4 else K
    if wq.shape[0] != rows:
        raise ValueError(f"codes have {wq.shape[0]} rows; K={K} at "
                         f"{bits} bits needs {rows}")
    if step.shape[0] != wq.shape[1]:
        raise ValueError(f"step has {step.shape[0]} entries for "
                         f"{wq.shape[1]} output columns")
    if wq.dtype != torch.int8:
        raise ValueError(f"quant_matmul codes must be int8, got {wq.dtype}")
    if step.dtype != torch.float32:
        raise ValueError(f"quant_matmul step must be f32, got {step.dtype}")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"quant_matmul takes bf16 or f32 x, got {x.dtype}")
    if not (x.device == wq.device == step.device):
        raise ValueError("x, codes and step must lie on one device")
    if not (x.is_contiguous() and wq.is_contiguous()
            and step.is_contiguous()):
        raise ValueError("quant_matmul kernel needs contiguous operands")


def quant_matmul(x, wq, step, bits: int = 8):
    """``x [M, K] @ dequant(wq) -> [M, N]`` f32. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel that
    :func:`quant_matmul_route` picks (any M, K, N; int4 needs an even K) or
    raises."""
    _check_inputs(x, wq, step, bits)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, wq, step, bits)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    M, K = x.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    vec = int(N % 16 == 0 and wq.data_ptr() % 16 == 0)
    route = quant_matmul_route(
        M, K, N, bits, x.dtype,
        x.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0)
    err = _lib()(x.data_ptr(), wq.data_ptr(), step.data_ptr(),
                 out.data_ptr(), M, K, N, bits, _X_DTYPES[x.dtype], vec,
                 ROUTES.index(route),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"quant_matmul ({route})")
    quant_matmul.launches += 1
    quant_matmul.routes[route] += 1
    return out


quant_matmul.launches = 0
quant_matmul.routes = dict.fromkeys(ROUTES, 0)

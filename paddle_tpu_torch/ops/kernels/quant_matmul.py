"""Weight-only dequant-matmul: the CUDA kernel ``csrc/quant_matmul.cu``
and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/quant_matmul.py. ``quant_matmul(x, wq,
step, bits)`` computes ``x [M, K] @ dequant(wq) -> [M, N]`` f32, with
``wq`` int8 codes ``[K, N]`` (bits 8) or int4 codes packed two per byte
along K ``[K/2, N]`` (bits 4, ``gpt_quant.pack_int4`` layout) and ``step``
the f32 ``[N]`` per-output-column steps. The codes multiply in x's dtype
(int8 and int4 magnitudes are exact in bf16), the sum is f32, and the step
multiplies the sum once.

Four hand-written kernels, one chosen by shape before the launch
(:func:`quant_matmul_route`): the decode form ``gemv`` (bf16 x, M <= 8:
codes converted to bf16 in registers for ``mma.sync`` with the rows of x
as the n = 8 side, a cluster of blocks splitting K whose partial sums meet
in rank order through distributed shared memory, :func:`gemv_split`), the
prefill form ``wgmma`` (bf16 x on the tensor cores, tiles in by TMA, codes
converted to bf16 in shared memory), ``wmma`` for the prefill shapes TMA
cannot map, and ``skinny`` (CUDA-core FMAs, one block per 16 columns) for
f32 x and the decode shapes ``gemv`` cannot map. Each launch is counted in
``quant_matmul.launches`` and in ``quant_matmul.routes``.
"""
from __future__ import annotations

import ctypes

import torch

from ...quantization.gpt_quant import unpack_int4
from . import _build
from .primitives import f32_mm

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("skinny", "wmma", "wgmma", "gemv")  # the C entry's route numbers

# csrc/quant_matmul.cu, gemv_route: the columns a cluster owns, the packed
# code rows of a ring stage (a rank sums whole stages), the most blocks a
# cluster holds and the most K rows of x a block stages
GEMV_BN = 128
GEMV_STAGE_ROWS = 128
GEMV_MAX_SPLIT = 4
GEMV_MAX_SLICE_K = 4096


def gemv_rows_per(K: int, bits: int, split: int) -> int:
    """The packed code rows a rank of a gemv cluster sums: ``ceil(R /
    split)`` (R = K, or K / 2 for int4) rounded up to whole ring stages of
    :data:`GEMV_STAGE_ROWS`; the last ranks may get fewer, or none."""
    R = K // 2 if bits == 4 else K
    return -(-(-(-R // split)) // GEMV_STAGE_ROWS) * GEMV_STAGE_ROWS


def gemv_slice_k(K: int, bits: int, split: int) -> int:
    """The K rows of x one rank stages (its packed rows times the K rows a
    packed row holds)."""
    return gemv_rows_per(K, bits, split) * (2 if bits == 4 else 1)


def gemv_split(M: int, K: int, N: int, bits: int, sms: int) -> int:
    """The blocks of a gemv cluster, which split K: the largest power of
    two, at most :data:`GEMV_MAX_SPLIT`, that keeps the ``ceil(N / 128)``
    clusters within one block an SM; doubled while a rank's x slice exceeds
    :data:`GEMV_MAX_SLICE_K`, then halved while a rank would get less than
    one stage of rows (short K). M does not change it."""
    R = K // 2 if bits == 4 else K
    tiles = -(-N // GEMV_BN)
    split = 1
    while split < GEMV_MAX_SPLIT and tiles * split * 2 <= sms:
        split *= 2
    while split < GEMV_MAX_SPLIT \
            and gemv_slice_k(K, bits, split) > GEMV_MAX_SLICE_K:
        split *= 2
    while split > 1 and -(-R // split) < GEMV_STAGE_ROWS \
            and gemv_slice_k(K, bits, split // 2) <= GEMV_MAX_SLICE_K:
        split //= 2
    return split


def quant_matmul_route(M: int, K: int, N: int, bits: int, x_dtype,
                       aligned: bool) -> str:
    """The kernel a CUDA call of :func:`quant_matmul` launches. Decode
    (M <= 8, bound by the code bytes): ``gemv`` for bf16 x where its
    16-byte code rows and x loads map (N % 16 == 0, K % 8 == 0;
    ``aligned``: x's and the codes' base pointers 16-byte aligned) and a
    rank's x slice at the widest split fits, else ``skinny``; f32 x always takes ``skinny``. Prefill: ``wgmma``
    where TMA can map x [M, K] bf16 and the codes [K or K/2, N] int8
    (16-byte row strides, N % 16 == 0 and K % 8 == 0, ``aligned``), else
    ``wmma``. ``bits`` changes no rule but the x slice's: int4's packed
    rows keep the codes' N-byte stride and halve K's."""
    if bits not in (4, 8):
        raise ValueError(f"quant_matmul supports bits in (4, 8), got {bits}")
    if x_dtype != torch.bfloat16:
        return "skinny"
    if M <= 8:
        if aligned and N % 16 == 0 and K % 8 == 0 and gemv_slice_k(
                K, bits, GEMV_MAX_SPLIT) <= GEMV_MAX_SLICE_K:
            return "gemv"
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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_SMS: dict[int, int] = {}


def _sm_count(device) -> int:
    """The SMs of a CUDA device (read once a device)."""
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


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
    split = (gemv_split(M, K, N, bits, _sm_count(x.device))
             if route == "gemv" else 0)
    err = _lib()(x.data_ptr(), wq.data_ptr(), step.data_ptr(),
                 out.data_ptr(), M, K, N, bits, _X_DTYPES[x.dtype], vec,
                 ROUTES.index(route), split,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"quant_matmul ({route})")
    quant_matmul.launches += 1
    quant_matmul.routes[route] += 1
    return out


quant_matmul.launches = 0
quant_matmul.routes = dict.fromkeys(ROUTES, 0)

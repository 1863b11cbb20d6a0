"""Length-bounded decode attention: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch versions.

Port of paddle_tpu/ops/pallas/decode_attention.py for the dense cache
(the scaled-int8 and paged forms belong to later slices). A window of Q
query rows ``q [B, H, Q, d]`` attends a ring-buffer cache
``[B, H, S, d]``: row j of batch row b sees keys ``<= pos[b] + j``.
Scores, softmax and accumulation are f32 and the result is f32 — callers
cast back.

Masked keys contribute exactly 0 (``exp(-1e30 - m)`` underflows to +0.0
in f32), so a row's result does not depend on how many dead blocks the
batch-wide trip count of the plain bounded loop makes it scan.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build
from .primitives import NEG_INF, online_softmax_update

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
MAX_Q = 8


def dense_decode_attention(q, k_cache, v_cache, pos, scale):
    """The full-buffer formulation (``PADDLE_TPU_DECODE_ATTN=full``),
    port of ``_dense_decode_attention``: f32 scores against every cache
    slot, divided by ``1/scale``, masked past ``pos + j``. Window rows
    run one at a time, as in the reference."""
    kf, vf = k_cache.float(), v_cache.float()
    idx = torch.arange(k_cache.shape[2], device=q.device)
    outs = []
    for j in range(q.shape[2]):
        logits = torch.matmul(q[:, :, j:j + 1].float(), kf.transpose(-1, -2))
        logits = logits / (1.0 / scale)
        live = idx[None, None, None, :] <= (pos + j)[:, None, None, None]
        logits = torch.where(live, logits, torch.full_like(logits, NEG_INF))
        outs.append(torch.matmul(torch.softmax(logits, dim=-1), vf))
    return torch.cat(outs, dim=2)


def bounded_decode_attention(q, k_cache, v_cache, pos, scale, block):
    """Online softmax over only the live k-blocks, port of
    ``_xla_bounded_decode_attention``: ``ceil((max(pos) + Q) / block)``
    blocks of ``block`` keys (``S % block == 0``), scores multiplied by
    ``scale``. The score products run one window row at a time so a
    Q-wide window matches Q single-row calls."""
    B, H, S, d = k_cache.shape
    Q = q.shape[2]
    qf = q.float()
    n_live = (int(pos.max()) + (Q - 1) + block) // block
    m = torch.full((B, H, Q, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Q, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Q, d), dtype=torch.float32, device=q.device)
    for i in range(min(n_live, S // block)):
        start = i * block
        kb = k_cache[:, :, start:start + block].float()
        vb = v_cache[:, :, start:start + block].float()
        idx = start + torch.arange(block, device=q.device)
        rows = []
        for j in range(Q):
            s = torch.matmul(qf[:, :, j:j + 1], kb.transpose(-1, -2)) * scale
            live = idx[None, None, None, :] <= (pos + j)[:, None, None, None]
            rows.append(torch.where(live, s, torch.full_like(s, NEG_INF)))
        m, l, acc = online_softmax_update(m, l, acc, torch.cat(rows, dim=2),
                                          vb)
    return acc / torch.where(l == 0.0, torch.ones_like(l), l)


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k_cache, v_cache, pos):
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or q.shape[:2] != k_cache.shape[:2] \
            or q.shape[3] != k_cache.shape[3]:
        raise ValueError(f"decode_attention wants q [B,H,Q,d], caches "
                         f"[B,H,S,d]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if not 1 <= q.shape[2] <= MAX_Q:
        raise ValueError(f"decode_attention kernel takes 1..{MAX_Q} query "
                         f"rows, got {q.shape[2]}")
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in _DTYPES:
        raise ValueError(f"decode_attention kernel takes a bf16 or f32 "
                         f"cache, got {k_cache.dtype}/{v_cache.dtype}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"decode_attention kernel head dim must be one of "
                         f"{_HEAD_DIMS}, got {q.shape[3]}")
    if not (q.device == k_cache.device == v_cache.device == pos.device):
        raise ValueError("q, caches and pos must lie on one device")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention kernel needs contiguous caches")


def decode_attention(q, k_cache, v_cache, pos, scale=None, block=128):
    """q: [B, H, Q, d]; k/v_cache: [B, H, S, d]; pos: int or [B] int
    tensor, the highest live cache index of window row 0. Returns
    [B, H, Q, d] f32.

    ``PADDLE_TPU_DECODE_ATTN`` picks the plain version run on CPU
    tensors: ``bounded`` (default, the online softmax over ``block``-key
    blocks up to the longest live row) or ``full`` (every cache slot).
    CUDA tensors launch the kernel in either mode — it reads exactly the
    live keys of each row — or raise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    pos = torch.as_tensor(pos, device=q.device)
    if pos.dim() == 0:
        pos = pos.expand(q.shape[0])
    mode = os.environ.get("PADDLE_TPU_DECODE_ATTN", "bounded")
    if mode not in ("full", "bounded"):
        raise ValueError(
            f"PADDLE_TPU_DECODE_ATTN={mode!r} unknown: expected 'bounded' "
            "(length-bounded online softmax) or 'full' (legacy dense)")
    if q.device.type == "cpu":
        if mode == "full":
            return dense_decode_attention(q, k_cache, v_cache, pos, scale)
        S = k_cache.shape[2]
        block = min(block, S)
        if S % block:
            # a non-dividing block would need a ragged last tile: one
            # full-width block keeps the exact masking semantics
            block = S
        return bounded_decode_attention(q, k_cache, v_cache, pos, scale,
                                        block)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    _check_inputs(q, k_cache, v_cache, pos)
    B, H, Q, d = q.shape
    qf = q.float().contiguous()
    p32 = pos.to(torch.int32).contiguous()
    out = torch.empty((B, H, Q, d), dtype=torch.float32, device=q.device)
    err = _lib()(qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 p32.data_ptr(), out.data_ptr(), B, H, k_cache.shape[2], Q, d,
                 _DTYPES[k_cache.dtype], float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

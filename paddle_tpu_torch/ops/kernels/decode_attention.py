"""Length-bounded decode attention: the CUDA kernels of
``csrc/decode_attention.cu`` and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/decode_attention.py for the dense cache and
the scaled-int8 cache (the paged forms belong to a later slice). A window
of Q query rows ``q [B, H, Q, d]`` attends a ring-buffer cache
``[B, H, S, d]``: row j of batch row b sees keys ``<= pos[b] + j``. A
cache is a bf16/f32 tensor, or the scaled-int8 pair ``(codes int8
[B, H, S, d], steps f32 [B, H, S])`` with one absmax step per position and
head (:func:`decode_attention_q8`; models/gpt.py owns the write side).
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


def _kv_parts(cache):
    """``(data, steps)`` of a scaled-int8 pair, ``(cache, None)`` of a
    plain cache."""
    if isinstance(cache, tuple):
        return cache
    return cache, None


def _dequant(data, steps):
    """f32 values of a cache (block): ``codes * step`` for the pair."""
    if steps is None:
        return data.float()
    return data.float() * steps[..., None]


def dense_decode_attention(q, k_cache, v_cache, pos, scale):
    """The full-buffer formulation (``PADDLE_TPU_DECODE_ATTN=full``),
    port of ``_dense_decode_attention``: f32 scores against every cache
    slot (a scaled-int8 cache dequantized whole up front), divided by
    ``1/scale``, masked past ``pos + j``. Window rows run one at a time,
    as in the reference."""
    kf, vf = _dequant(*_kv_parts(k_cache)), _dequant(*_kv_parts(v_cache))
    idx = torch.arange(kf.shape[2], device=q.device)
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
    ``scale``; a scaled-int8 cache is dequantized one block at a time
    (the reference's ``_block_f32``). The score products run one window row at a time so
    a Q-wide window matches Q single-row calls."""
    kd, kst = _kv_parts(k_cache)
    vd, vst = _kv_parts(v_cache)
    B, H, S, d = kd.shape
    Q = q.shape[2]
    qf = q.float()
    n_live = (int(pos.max()) + (Q - 1) + block) // block
    m = torch.full((B, H, Q, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Q, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Q, d), dtype=torch.float32, device=q.device)
    for i in range(min(n_live, S // block)):
        start = i * block
        win = slice(start, start + block)
        kb = _dequant(kd[:, :, win], None if kst is None else kst[:, :, win])
        vb = _dequant(vd[:, :, win], None if vst is None else vst[:, :, win])
        idx = start + torch.arange(block, device=q.device)
        rows = []
        for j in range(Q):
            s = torch.matmul(qf[:, :, j:j + 1], kb.transpose(-1, -2)) * scale
            live = idx[None, None, None, :] <= (pos + j)[:, None, None, None]
            rows.append(torch.where(live, s, torch.full_like(s, NEG_INF)))
        m, l, acc = online_softmax_update(m, l, acc, torch.cat(rows, dim=2),
                                          vb)
    return acc / torch.where(l == 0.0, torch.ones_like(l), l)


def _lib(name="decode_attention"):
    """The C entry ``name`` (``decode_attention`` or
    ``decode_attention_q8``) of the library, with its argument types."""
    fn = getattr(_build.load("decode_attention"), name)
    if fn.argtypes is None:
        if name == "decode_attention":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_common(q, k_data, v_data):
    if q.dim() != 4 or k_data.dim() != 4 or k_data.shape != v_data.shape \
            or q.shape[:2] != k_data.shape[:2] \
            or q.shape[3] != k_data.shape[3]:
        raise ValueError(f"decode_attention wants q [B,H,Q,d], caches "
                         f"[B,H,S,d]; got {tuple(q.shape)}, "
                         f"{tuple(k_data.shape)}, {tuple(v_data.shape)}")
    if not 1 <= q.shape[2] <= MAX_Q:
        raise ValueError(f"decode_attention kernel takes 1..{MAX_Q} query "
                         f"rows, got {q.shape[2]}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"decode_attention kernel head dim must be one of "
                         f"{_HEAD_DIMS}, got {q.shape[3]}")


def _check_inputs(q, k_cache, v_cache, pos):
    _check_common(q, k_cache, v_cache)
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in _DTYPES:
        raise ValueError(f"decode_attention kernel takes a bf16 or f32 "
                         f"cache, got {k_cache.dtype}/{v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == pos.device):
        raise ValueError("q, caches and pos must lie on one device")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention kernel needs contiguous caches")


def _check_q8_inputs(q, k_cache, v_cache, pos):
    if not (isinstance(k_cache, tuple) and isinstance(v_cache, tuple)
            and len(k_cache) == len(v_cache) == 2):
        raise ValueError("decode_attention_q8 takes (codes, steps) caches")
    (kd, ks), (vd, vs) = k_cache, v_cache
    _check_common(q, kd, vd)
    if kd.dtype != torch.int8 or vd.dtype != torch.int8:
        raise ValueError(f"decode_attention_q8 codes must be int8, got "
                         f"{kd.dtype}/{vd.dtype}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32 \
            or ks.shape != kd.shape[:3] or vs.shape != vd.shape[:3]:
        raise ValueError(f"decode_attention_q8 steps must be f32 [B,H,S] "
                         f"= {tuple(kd.shape[:3])}, got {tuple(ks.shape)} "
                         f"{ks.dtype}, {tuple(vs.shape)} {vs.dtype}")
    if len({t.device for t in (q, kd, vd, ks, vs, pos)}) != 1:
        raise ValueError("q, caches, steps and pos must lie on one device")
    if not all(t.is_contiguous() for t in (kd, vd, ks, vs)):
        raise ValueError("decode_attention_q8 kernel needs contiguous "
                         "codes and steps")


def _prepare(q, pos, scale):
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
    return pos, scale, mode


def _plain(q, k_cache, v_cache, pos, scale, block, mode):
    if mode == "full":
        return dense_decode_attention(q, k_cache, v_cache, pos, scale)
    S = _kv_parts(k_cache)[0].shape[2]
    block = min(block, S)
    if S % block:
        # a non-dividing block would need a ragged last tile: one
        # full-width block keeps the exact masking semantics
        block = S
    return bounded_decode_attention(q, k_cache, v_cache, pos, scale, block)


def decode_attention(q, k_cache, v_cache, pos, scale=None, block=128):
    """q: [B, H, Q, d]; k/v_cache: [B, H, S, d], or scaled-int8
    ``(codes, steps)`` pairs (handed to :func:`decode_attention_q8`);
    pos: int or [B] int tensor, the highest live cache index of window
    row 0. Returns [B, H, Q, d] f32.

    ``PADDLE_TPU_DECODE_ATTN`` picks the plain version run on CPU
    tensors: ``bounded`` (default, the online softmax over ``block``-key
    blocks up to the longest live row) or ``full`` (every cache slot).
    CUDA tensors launch the kernel in either mode — it reads exactly the
    live keys of each row — or raise."""
    if isinstance(k_cache, tuple):
        return decode_attention_q8(q, k_cache, v_cache, pos, scale, block)
    pos, scale, mode = _prepare(q, pos, scale)
    if q.device.type == "cpu":
        return _plain(q, k_cache, v_cache, pos, scale, block, mode)
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


def decode_attention_q8(q, k_cache, v_cache, pos, scale=None, block=128):
    """:func:`decode_attention` over the scaled-int8 cache: k/v_cache are
    ``(codes int8 [B, H, S, d], steps f32 [B, H, S])`` pairs. CPU tensors
    run the plain versions (dequantized whole for ``full``, block by block
    for ``bounded``); CUDA tensors launch the int8 kernel, which
    dequantizes each live key and value in registers, or raise."""
    pos, scale, mode = _prepare(q, pos, scale)
    if q.device.type == "cpu":
        return _plain(q, k_cache, v_cache, pos, scale, block, mode)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_q8: no kernel for {q.device}")
    _check_q8_inputs(q, k_cache, v_cache, pos)
    (kd, ks), (vd, vs) = k_cache, v_cache
    B, H, Q, d = q.shape
    qf = q.float().contiguous()
    p32 = pos.to(torch.int32).contiguous()
    out = torch.empty((B, H, Q, d), dtype=torch.float32, device=q.device)
    err = _lib("decode_attention_q8")(
        qf.data_ptr(), kd.data_ptr(), vd.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), p32.data_ptr(), out.data_ptr(), B, H, kd.shape[2], Q,
        d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_q8")
    decode_attention_q8.launches += 1
    return out


decode_attention.launches = 0
decode_attention_q8.launches = 0

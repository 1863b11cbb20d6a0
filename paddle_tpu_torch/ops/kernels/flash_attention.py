"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention_fwd.cu``
and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/flash_attention.py (forward only; the
backward kernels belong to the training slice). Layout ``[B, H, S, d]``;
the causal mask is aligned bottom-right (query i sees keys
``<= i + Skv - Sq``), which chunked prefill relies on when Sq < Skv.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .primitives import causal_mask

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def xla_attention(q, k, v, scale, causal, with_lse=False):
    """Plain attention, the port of ``_xla_attention``: f32 scores,
    ``-1e30`` causal mask, softmax, probabilities cast to q's dtype
    before the PV product (the CUDA kernel keeps them in f32, so the two
    differ by bf16 rounding in bf16). With ``with_lse`` also returns the
    per-row log-sum-exp [B, H, Sq] in f32."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = causal_mask(logits, 0, 0, k.shape[-2] - q.shape[-2])
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _lib():
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v, causal):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention wants q [B,H,Sq,d], k/v "
                         f"[B,H,Skv,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes one dtype of "
                         f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel head dim must be one of "
                         f"{_HEAD_DIMS}, got {q.shape[3]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(f"causal flash_attention needs Sq <= Skv, got "
                         f"Sq={q.shape[2]}, Skv={k.shape[2]}")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention needs Sq, Skv >= 1")


def flash_attention(q, k, v, scale=None, causal=False, with_lse=False):
    """q: [B, H, Sq, d], k/v: [B, H, Skv, d] -> [B, H, Sq, d] in q's
    dtype (and the f32 LSE [B, H, Sq] with ``with_lse``).

    CPU tensors run :func:`xla_attention`; CUDA tensors launch the
    kernel (bf16 or f32, d in 16/32/64/128, any Sq and Skv) or raise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return xla_attention(q, k, v, scale, causal, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    _check_inputs(q, k, v, causal)
    B, H, Sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None, B, H, Sq, k.shape[2],
                 d, _DTYPES[q.dtype], float(scale), int(bool(causal)),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0

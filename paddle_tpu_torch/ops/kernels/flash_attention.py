"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/flash_attention.py. Layout ``[B, H, S, d]``;
the causal mask is aligned bottom-right (query i sees keys
``<= i + Skv - Sq``), which chunked prefill relies on when Sq < Skv.

The forward's route depends on the dtype (:data:`FWD_ROUTES`): bf16 runs
on the tensor cores (wgmma, tiles in by TMA, an online softmax on the
accumulator fragment), f32 on the CUDA cores.

The backward is the reference's FlashAttention-2 pair: the forward keeps
the per-row log-sum-exp, and two kernels recompute each probability tile
from it — one accumulates dq over k tiles, the other dk and dv over q
tiles. Their route depends on the dtype (:data:`BWD_ROUTES`): bf16 runs
on the tensor cores (wgmma, TMA), f32 on the CUDA cores. :class:`FlashAttention` is the ``custom_vjp`` of the reference as a
``torch.autograd.Function``; on the CPU autograd differentiates
:func:`xla_attention` directly, the reference's own off-TPU route.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .primitives import causal_mask

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
# the forward and backward kernels' route by dtype: bf16 products on the
# tensor cores (wgmma, tiles in by TMA), f32 on the CUDA cores (a
# tensor-core f32 product would be TF32)
FWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "cuda-core f32"}
BWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "cuda-core f32"}


def xla_attention(q, k, v, scale, causal, with_lse=False):
    """Plain attention, the port of ``_xla_attention``: f32 scores,
    ``-1e30`` causal mask, softmax, probabilities cast to q's dtype
    before the PV product (the bf16 kernel rounds them against the running
    max of each 64-key tile, so the two differ by bf16 rounding in bf16).
    With ``with_lse`` also returns the per-row log-sum-exp [B, H, Sq] in
    f32."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = causal_mask(logits, 0, 0, k.shape[-2] - q.shape[-2])
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _probs(q, k, lse, scale, causal):
    """f32 probabilities ``exp(q k^T * scale - lse)``, masked ones exactly
    0 (not ``exp(-1e30 - lse)``, which the kernels never compute)."""
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                  - lse[..., None])
    if causal:
        sq, skv = q.shape[-2], k.shape[-2]
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        p = torch.where(rows >= torch.arange(skv, device=q.device)[None, :],
                        p, torch.zeros_like(p))
    return p


def bwd_dq_ref(q, k, v, dout, lse, di, scale, causal):
    """Plain version of the dq kernel: ``ds = p (dO v^T - di) scale``,
    ``dq = ds k``, f32 math, dq in q's dtype."""
    p = _probs(q, k, lse, scale, causal)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - di[..., None]) * scale
    return torch.matmul(ds, k.float()).to(q.dtype)


def bwd_dkv_ref(q, k, v, dout, lse, di, scale, causal):
    """Plain version of the dk/dv kernel: ``dk = ds^T q``, ``dv = p^T dO``
    with p rounded to q's dtype first, as :func:`xla_attention` rounds it
    before the PV product (the bf16 kernel also rounds ds to bf16 before
    its products; the f32 kernel keeps both in f32)."""
    p = _probs(q, k, lse, scale, causal)
    dof = dout.float()
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2))
              - di[..., None]) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def softmax_grad_rowsum(out, dout):
    """``di = rowsum(dO * O)`` in f32 [B, H, Sq]: a reduction the reference
    leaves to XLA outside its kernels, here to PyTorch."""
    return (dout.float() * out.float()).sum(-1)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, scale, causal):
    """The plain backward: the formula both kernels compute, from the
    forward's output and f32 LSE [B, H, Sq]. Returns (dq, dk, dv) in q's
    dtype."""
    di = softmax_grad_rowsum(out, dout)
    dq = bwd_dq_ref(q, k, v, dout, lse, di, scale, causal)
    return (dq, *bwd_dkv_ref(q, k, v, dout, lse, di, scale, causal))


def _lib(name="flash_attention_fwd"):
    """The C entry ``name`` of its library, with its argument types."""
    lib = _build.load("flash_attention_bwd" if name.startswith(
        "flash_attention_bwd") else "flash_attention_fwd")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptr = {"flash_attention_fwd": 5, "flash_attention_bwd_dq": 7,
                 "flash_attention_bwd_dkv": 8}[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
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


def _check_bwd_inputs(q, k, v, dout, lse, di, causal):
    _check_inputs(q, k, v, causal)
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or not dout.is_contiguous() or dout.device != q.device:
        raise ValueError(f"flash_attention backward wants dO contiguous, "
                         f"shaped and typed as q {tuple(q.shape)} "
                         f"{q.dtype}; got {tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention backward wants {name} f32 "
                             f"contiguous {tuple(q.shape[:3])}; got "
                             f"{tuple(t.shape)} {t.dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, scale, causal, with_lse):
    _check_inputs(q, k, v, causal)
    B, H, Sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None, B, H, Sq, k.shape[2],
                 d, _DTYPES[q.dtype], float(scale), int(bool(causal)),
                 _stream(q))
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, scale=None, causal=False, with_lse=False):
    """q: [B, H, Sq, d], k/v: [B, H, Skv, d] -> [B, H, Sq, d] in q's
    dtype (and the f32 LSE [B, H, Sq] with ``with_lse``).

    CPU tensors run :func:`xla_attention` (autograd differentiates it);
    CUDA tensors launch the kernel (bf16 or f32, d in 16/32/64/128, any Sq
    and Skv) or raise. On CUDA with grad enabled and an input that
    requires grad, the call goes through :class:`FlashAttention`, whose
    backward launches the two backward kernels."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return xla_attention(q, k, v, scale, causal, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if with_lse:
            raise ValueError("flash_attention: the LSE output has no "
                             "backward; call it under torch.no_grad()")
        return FlashAttention.apply(q, k, v, float(scale), bool(causal))
    return _launch_fwd(q, k, v, scale, causal, with_lse)


flash_attention.launches = 0


def flash_attention_bwd_dq(q, k, v, dout, lse, di, scale, causal):
    """dq [B, H, Sq, d] in q's dtype. CPU tensors run :func:`bwd_dq_ref`;
    CUDA tensors launch the dq kernel or raise."""
    if q.device.type == "cpu":
        return bwd_dq_ref(q, k, v, dout, lse, di, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dq: no kernel for {q.device}")
    _check_bwd_inputs(q, k, v, dout, lse, di, causal)
    B, H, Sq, d = q.shape
    dq = torch.empty_like(q)
    err = _lib("flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, H, Sq, k.shape[2],
        d, _DTYPES[q.dtype], float(scale), int(bool(causal)), _stream(q))
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, di, scale, causal):
    """(dk, dv) [B, H, Skv, d] in k's dtype. CPU tensors run
    :func:`bwd_dkv_ref`; CUDA tensors launch the dk/dv kernel or raise."""
    if q.device.type == "cpu":
        return bwd_dkv_ref(q, k, v, dout, lse, di, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dkv: no kernel for "
                         f"{q.device}")
    _check_bwd_inputs(q, k, v, dout, lse, di, causal)
    B, H, Sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib("flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
        Sq, k.shape[2], d, _DTYPES[q.dtype], float(scale), int(bool(causal)),
        _stream(q))
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, scale=None, causal=False):
    """(dq, dk, dv) from the forward's inputs, output and f32 LSE
    [B, H, Sq]: :func:`flash_attention_bwd_ref` on CPU tensors, the dq
    and dk/dv kernels on CUDA tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    di = softmax_grad_rowsum(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, di, scale, causal)
    return (dq, *flash_attention_bwd_dkv(q, k, v, dout, lse, di, scale,
                                         causal))


class FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` on the card: the forward kernel keeps
    the LSE, the backward runs the dq and dk/dv kernels on it."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = _launch_fwd(q, k, v, scale, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.scale,
                                         ctx.causal)
        return dq, dk, dv, None, None

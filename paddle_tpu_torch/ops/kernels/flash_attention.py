"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/flash_attention.py. Layout ``[B, H, S, d]``;
the causal mask is aligned bottom-right (query i sees keys
``<= i + Skv - Sq``), which chunked prefill relies on when Sq < Skv.

The kernels' route depends on the dtype (:data:`ROUTES`): bf16 and
float16 run on the tensor cores (wgmma, tiles in by TMA, an online
softmax on the accumulator fragment; one kernel template on the 16-bit
type), f32 on the CUDA cores.

The backward is the reference's FlashAttention-2 pair: the forward keeps
the per-row log-sum-exp, and two kernels recompute each probability tile
from it — one accumulates dq over k tiles, the other dk and dv over q
tiles. They take the forward's routes.

The three launches are ``torch.library`` custom ops (``paddle_tpu::
flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``), each with a fake
implementation, and the forward with the backward ops as its registered
autograd: a ``torch.compile`` or ``torch.export`` graph holds each as one
node, and its body runs, and counts its launch, when the graph runs. On a
CUDA tensor an op launches its kernel or raises; on a CPU tensor it runs
the plain version. The wrappers below call the ops on CUDA tensors; on
the CPU :func:`flash_attention` differentiates :func:`xla_attention`
directly, the reference's own off-TPU route.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .primitives import causal_mask

# the C entries' dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (16, 32, 64, 128)
# the three kernels' route by dtype: bf16 and f16 products on the tensor
# cores (wgmma, tiles in by TMA), f32 on the CUDA cores (a tensor-core f32
# product would be TF32)
ROUTES = {torch.bfloat16: "wgmma", torch.float16: "wgmma",
          torch.float32: "cuda-core f32"}


def xla_attention(q, k, v, scale, causal, with_lse=False, bias=None):
    """Plain attention, the port of ``_xla_attention``: f32 scores, plus
    the additive ``bias`` in f32 where given, ``-1e30`` causal mask,
    softmax, probabilities cast to q's dtype before the PV product (the
    16-bit kernels round them against the running max of each 64-key
    tile, so the two differ by that rounding in bf16 and f16). With ``with_lse`` also
    returns the per-row log-sum-exp [B, H, Sq] in f32."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
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
    _count(flash_attention, q.dtype)
    return out, lse


def _count(wrapper, dtype):
    """One launch of ``wrapper``'s kernel, by route (counted in the op's
    body, so a compiled or exported graph counts its runs)."""
    wrapper.launches += 1
    route = ROUTES[dtype]
    wrapper.routes[route] = wrapper.routes.get(route, 0) + 1


def _on_card(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {t.device}")


# ------------------------------------------------------------ custom ops
@torch.library.custom_op("paddle_tpu::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool, with_lse: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse); lse is empty [0] without ``with_lse``."""
    if q.device.type == "cpu":
        out, lse = xla_attention(q, k, v, scale, causal, True)
        return out, (lse if with_lse else lse.new_empty((0,)))
    _on_card(q, "flash_attention")
    out, lse = _launch_fwd(q, k, v, scale, causal, with_lse)
    return out, (lse if with_lse else out.new_empty((0,),
                                                    dtype=torch.float32))


@_flash_fwd_op.register_fake
def _(q, k, v, scale, causal, with_lse):
    lse_shape = tuple(q.shape[:3]) if with_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


@torch.library.custom_op("paddle_tpu::flash_bwd_dq", mutates_args=())
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, lse: torch.Tensor, di: torch.Tensor,
                     scale: float, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return bwd_dq_ref(q, k, v, dout, lse, di, scale, causal)
    _on_card(q, "flash_attention_bwd_dq")
    _check_bwd_inputs(q, k, v, dout, lse, di, causal)
    B, H, Sq, d = q.shape
    dq = torch.empty_like(q)
    err = _lib("flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, H, Sq, k.shape[2],
        d, _DTYPES[q.dtype], float(scale), int(bool(causal)), _stream(q))
    _build.check(err, "flash_attention_bwd_dq")
    _count(flash_attention_bwd_dq, q.dtype)
    return dq


@_flash_bwd_dq_op.register_fake
def _(q, k, v, dout, lse, di, scale, causal):
    return torch.empty_like(q)


@torch.library.custom_op("paddle_tpu::flash_bwd_dkv", mutates_args=())
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor,
                      di: torch.Tensor, scale: float, causal: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return bwd_dkv_ref(q, k, v, dout, lse, di, scale, causal)
    _on_card(q, "flash_attention_bwd_dkv")
    _check_bwd_inputs(q, k, v, dout, lse, di, causal)
    B, H, Sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib("flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
        Sq, k.shape[2], d, _DTYPES[q.dtype], float(scale), int(bool(causal)),
        _stream(q))
    _build.check(err, "flash_attention_bwd_dkv")
    _count(flash_attention_bwd_dkv, q.dtype)
    return dk, dv


@_flash_bwd_dkv_op.register_fake
def _(q, k, v, dout, lse, di, scale, causal):
    return torch.empty_like(k), torch.empty_like(v)


def _fwd_setup(ctx, inputs, output):
    q, k, v, scale, causal, _ = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale, ctx.causal = scale, causal


def _fwd_backward(ctx, dout, dlse):
    """The reference's ``custom_vjp`` backward: the dq and dk/dv ops on
    the forward's f32 LSE (the LSE output itself has no gradient)."""
    q, k, v, out, lse = ctx.saved_tensors
    if lse.numel() == 0:
        raise RuntimeError("paddle_tpu::flash_fwd was recorded with "
                           "with_lse=False: its backward needs the LSE")
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                     ctx.scale, ctx.causal)
    return dq, dk, dv, None, None, None


torch.library.register_autograd("paddle_tpu::flash_fwd", _fwd_backward,
                                setup_context=_fwd_setup)

OPS = (torch.ops.paddle_tpu.flash_fwd, torch.ops.paddle_tpu.flash_bwd_dq,
       torch.ops.paddle_tpu.flash_bwd_dkv)


# -------------------------------------------------------------- wrappers
def flash_attention(q, k, v, scale=None, causal=False, with_lse=False):
    """q: [B, H, Sq, d], k/v: [B, H, Skv, d] -> [B, H, Sq, d] in q's
    dtype (and the f32 LSE [B, H, Sq] with ``with_lse``).

    CPU tensors run :func:`xla_attention` (autograd differentiates it);
    CUDA tensors run the ``paddle_tpu::flash_fwd`` op, which launches the
    kernel (bf16, f16 or f32, d in 16/32/64/128, any Sq and Skv) or
    raises; under autograd its backward runs the two backward ops."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return xla_attention(q, k, v, scale, causal, with_lse)
    _on_card(q, "flash_attention")
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if with_lse and grad:
        raise ValueError("flash_attention: the LSE output has no "
                         "backward; call it under torch.no_grad()")
    # the backward reads the LSE: keep it whenever autograd records
    out, lse = torch.ops.paddle_tpu.flash_fwd(q, k, v, float(scale),
                                              bool(causal),
                                              bool(with_lse or grad))
    return (out, lse) if with_lse else out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(sorted(set(ROUTES.values())), 0)


def flash_attention_bwd_dq(q, k, v, dout, lse, di, scale, causal):
    """dq [B, H, Sq, d] in q's dtype. CPU tensors run :func:`bwd_dq_ref`;
    CUDA tensors launch the dq kernel (the ``paddle_tpu::flash_bwd_dq``
    op) or raise."""
    if q.device.type == "cpu":
        return bwd_dq_ref(q, k, v, dout, lse, di, scale, causal)
    _on_card(q, "flash_attention_bwd_dq")
    return torch.ops.paddle_tpu.flash_bwd_dq(q, k, v, dout, lse, di,
                                             float(scale), bool(causal))


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.routes = dict.fromkeys(
    sorted(set(ROUTES.values())), 0)


def flash_attention_bwd_dkv(q, k, v, dout, lse, di, scale, causal):
    """(dk, dv) [B, H, Skv, d] in k's dtype. CPU tensors run
    :func:`bwd_dkv_ref`; CUDA tensors launch the dk/dv kernel (the
    ``paddle_tpu::flash_bwd_dkv`` op) or raise."""
    if q.device.type == "cpu":
        return bwd_dkv_ref(q, k, v, dout, lse, di, scale, causal)
    _on_card(q, "flash_attention_bwd_dkv")
    return torch.ops.paddle_tpu.flash_bwd_dkv(q, k, v, dout, lse, di,
                                              float(scale), bool(causal))


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.routes = dict.fromkeys(
    sorted(set(ROUTES.values())), 0)


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

"""Tile-level building blocks shared by the plain versions of the kernels
(port of the compute half of paddle_tpu/ops/pallas/primitives.py)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def causal_mask(scores, q_start: int, k_start: int, offset: int = 0):
    """Mask ``scores[..., i, j]`` where global query index i (plus
    ``offset``) is below global key index j. ``offset = kv_len - q_len``
    aligns the diagonal bottom-right, the convention of every attention
    in the package: query i sees keys ``<= i + offset``."""
    bq, bk = scores.shape[-2], scores.shape[-1]
    rows = torch.arange(bq, device=scores.device)[:, None]
    cols = torch.arange(bk, device=scores.device)[None, :]
    keep = (q_start + rows + offset) >= (k_start + cols)
    return torch.where(keep, scores, torch.full_like(scores, NEG_INF))


def f32_mm(a, b):
    """``a @ b`` [M, K] x [K, N] -> [M, N] f32 with the operands in a's
    dtype and f32 accumulation: ``torch.mm(..., out_dtype=float32)`` for a
    bf16 product on the card (f32 straight from the accumulator; a plain
    bf16 matmul would round the result to bf16), the operands upcast to f32
    on the CPU (bf16 x bf16 is exact in f32, so the products are the
    same)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def online_softmax_update(m_prev, l_prev, acc_prev, scores, values):
    """One block step of the streaming softmax, all f32: returns
    ``(m_new, l_new, acc_new)`` from the running max ``m`` [..., q, 1],
    normaliser ``l`` [..., q, 1], weighted accumulator ``acc``
    [..., q, d] and this block's ``scores`` [..., q, k] / ``values``
    [..., k, d]."""
    m_new = torch.maximum(m_prev, scores.amax(-1, keepdim=True))
    p = torch.exp(scores - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(-1, keepdim=True)
    acc_new = acc_prev * alpha + torch.matmul(p, values)
    return m_new, l_new, acc_new

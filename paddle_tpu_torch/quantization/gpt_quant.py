"""Weight-only quantization for GPT serving — port of
paddle_tpu/quantization/gpt_quant.py.

**Weight-only quantized params**: the FFN ``w_in``/``w_out`` and the
``wte`` table (lm-head and embedding) are stored as int8 codes (or int4
codes packed two per byte) with ONE f32 step per output channel.
Activations stay in the model dtype; the product runs on the codes cast
to the activation dtype with f32 accumulation, and the per-output-channel
step multiplies the f32 sum once (the step factors out of the sum, so no
dequantized weight is ever materialised). The two FFN products go through
the ``quant_matmul`` kernel (``ops/kernels/quant_matmul.py``); the lm-head
stays a plain product, as in the reference (its codes are packed along
the trailing axis, not in the kernel's [K, N] layout).

**Layout** — per-OUTPUT-channel symmetric absmax, stored as the STEP
(``absmax / qmax``) so dequantization is one multiply:

=========  ==================  ============  =====================
leaf       shape               out-ch axis   int4 pack axis
=========  ==================  ============  =====================
w_in       [L, D, 4D]          -1 (4D)       -2 (D, contraction)
w_out      [L, 4D, D]          -1 (D)        -2 (4D, contraction)
wte        [V, D]              0  (V rows)   -1 (D, contraction)
=========  ==================  ============  =====================

The codes equal the reference's bit for bit: the range is symmetric
(±127, ±7), the absmax is divided by qmax and the weight by its step
(never multiplied by a reciprocal, see :func:`_div`), rounding is half to
even (``torch.round``), the step floor is 1e-8, and int4 keeps the even
index in the low nibble.
"""
from __future__ import annotations

import torch

from ..ops.kernels.primitives import f32_mm

__all__ = [
    "W_BITS", "quantize_weight", "pack_int4", "unpack_int4",
    "quantize_gpt_params", "wq_einsum", "dequant_rows", "quantize_rows",
    "quant_param_stats", "kv_cache_quantized", "tree_bytes",
]

# cfg.weight_quant values -> integer bit width
W_BITS = {"int8": 8, "int4": 4}

# symmetric signed range: int8 codes in [-127, 127], int4 in [-7, 7]
_QMAX = {8: 127.0, 4: 7.0}
_STEP_FLOOR = 1e-8


def _check_bits(bits: int) -> float:
    if bits not in _QMAX:
        raise ValueError(f"weight quantization supports bits in (4, 8), "
                         f"got {bits}")
    return _QMAX[bits]


def _div(num, den: float):
    """``num / den`` as a true f32 division on every device. PyTorch's
    CUDA kernel turns a division by a Python scalar into a multiplication
    by its reciprocal, which can be one ulp off the quotient; a 0-dim
    tensor on num's device keeps it a division."""
    return num / torch.full((), den, dtype=num.dtype, device=num.device)


def quantize_rows(x):
    """Symmetric scaled-int8 quantization of the TRAILING axis: one absmax
    step per leading-index row (the KV-cache write discipline: per
    position per head). Returns ``(codes int8, step f32[leading...])``;
    dequantization is ``codes * step[..., None]``."""
    xf = x.float()
    step = _div(xf.abs().amax(-1), _QMAX[8]).clamp_min(_STEP_FLOOR)
    codes = torch.round(xf / step[..., None]).clamp(-_QMAX[8], _QMAX[8])
    return codes.to(torch.int8), step


def quantize_weight(w, bits: int = 8, axis: int = -1):
    """Symmetric per-output-channel absmax quantization. ``axis`` is the
    OUTPUT-channel axis; the absmax reduces over the other axis of the
    trailing two (leading stack dims, e.g. the layer dim, keep their own
    steps: a [L, D, F] weight reduces over D only, giving [L, F]).
    Returns ``(codes int8, step f32)``; codes are not packed."""
    qmax = _check_bits(bits)
    wf = w.float()
    axis = axis % wf.dim()
    if wf.dim() == 2:
        red = tuple(a for a in range(2) if a != axis)
    else:
        red = tuple(a for a in range(wf.dim())
                    if a != axis and a >= wf.dim() - 2)
    absmax = wf.abs().amax(dim=red, keepdim=True) if red else wf.abs()
    step_b = _div(absmax, qmax).clamp_min(_STEP_FLOOR)
    q = torch.round(wf / step_b).clamp(-qmax, qmax).to(torch.int8)
    step = step_b.squeeze(red) if red else step_b
    return q, step


def pack_int4(q, axis: int = -2):
    """Pack int4 codes (int8 storage, values in [-7, 7]) two per byte
    along ``axis``: even index in the low nibble, odd in the high.
    ``q.shape[axis]`` must be even."""
    q = q.movedim(axis, -1)
    n = q.shape[-1]
    if n % 2:
        raise ValueError(f"pack axis length {n} must be even")
    pairs = q.reshape(*q.shape[:-1], n // 2, 2).to(torch.int16)
    byte = (pairs[..., 0] & 0x0F) | ((pairs[..., 1] << 4) & 0xF0)
    # 0..255 -> the int8 of the same bits
    return byte.to(torch.uint8).view(torch.int8).movedim(-1, axis)


def unpack_int4(p, axis: int = -2):
    """Inverse of :func:`pack_int4`: bytes -> int4 codes as int8, each
    nibble sign-extended (the reference's two arithmetic shifts)."""
    p = p.movedim(axis, -1).to(torch.int16)
    lo = ((p & 0x0F) ^ 0x08) - 0x08
    hi = p >> 4
    q = torch.stack([lo, hi], dim=-1)
    q = q.reshape(*q.shape[:-2], q.shape[-2] * 2)
    return q.to(torch.int8).movedim(-1, axis)


def _maybe_pack(q, bits: int, axis: int):
    return pack_int4(q, axis=axis) if bits == 4 else q


def quantize_gpt_params(params, cfg, bits: int = 8):
    """Weight-only quantize a ``models/gpt.py`` parameter tree for
    serving: FFN ``w_in``/``w_out`` and ``wte`` become int8 (int4-packed)
    codes with a ``<name>_s`` f32 step sibling; everything else keeps the
    model dtype. Returns a NEW tree (the fp leaves are shared), consumed
    through ``cfg.weight_quant`` ("int8" for bits=8, "int4" for
    bits=4), on the device the params live on."""
    _check_bits(bits)
    if cfg.weight_quant is not None and W_BITS[cfg.weight_quant] != bits:
        raise ValueError(
            f"cfg.weight_quant={cfg.weight_quant!r} disagrees with "
            f"bits={bits} — the params and the consuming programs must "
            "commit to one width")
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in ("w_in", "w_out"):
        q, step = quantize_weight(blocks[name], bits, axis=-1)
        blocks[name] = _maybe_pack(q, bits, axis=-2)
        blocks[name + "_s"] = step
    out["blocks"] = blocks
    q, step = quantize_weight(params["wte"], bits, axis=0)
    out["wte"] = _maybe_pack(q, bits, axis=-1)
    out["wte_s"] = step
    return out


# einsum equations whose weight operand is a [K, N] matrix (contraction
# axis leading, codes packed along it): the quant_matmul kernel's layout
_MATMUL_EQS = ("bsd,de->bse", "bse,ed->bsd")
_LM_HEAD_EQ = "bsd,vd->bsv"


def wq_einsum(eq: str, x, q, step, bits: int, pack_axis: int = -2):
    """``einsum(eq, x, W)`` against weight-only quantized ``W`` for the
    serving sites: the FFN forms of ``_MATMUL_EQS`` through the
    ``quant_matmul`` kernel, and the lm-head ``"bsd,vd->bsv"`` as a plain
    product (codes unpacked along D, cast to x's dtype, f32 output, then
    the per-row step). Returns f32; callers cast back."""
    if eq in _MATMUL_EQS:
        from ..ops.kernels.quant_matmul import quant_matmul
        lead = x.shape[:-1]
        acc = quant_matmul(x.reshape(-1, x.shape[-1]), q, step, bits)
        return acc.reshape(*lead, acc.shape[-1])
    if eq != _LM_HEAD_EQ:
        raise ValueError(f"wq_einsum: {eq!r} is not a serving-path site "
                         f"(expected one of {_MATMUL_EQS + (_LM_HEAD_EQ,)})")
    if bits == 4:
        q = unpack_int4(q, axis=pack_axis)
    acc = f32_mm(x.reshape(-1, x.shape[-1]), q.to(x.dtype).t()) * step
    return acc.reshape(*x.shape[:-1], q.shape[0])


def dequant_rows(rows, step_rows, bits: int, pack_axis: int = -1):
    """Dequantize GATHERED table rows (the embedding side of a quantized
    ``wte``): codes picked by an index, times their per-row steps. Returns
    f32."""
    if bits == 4:
        rows = unpack_int4(rows, axis=pack_axis)
    return rows.float() * step_rows[..., None]


def kv_cache_quantized(cfg) -> bool:
    """Whether ``cfg.kv_cache_dtype`` selects the scaled-int8 cache (the
    string ``"int8"``; dtypes keep the plain narrow-dtype cache)."""
    return isinstance(cfg.kv_cache_dtype, str) \
        and cfg.kv_cache_dtype == "int8"


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    """Resident bytes of a tree (dicts, tuples, lists) of tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def quant_param_stats(qparams, cfg) -> dict:
    """Byte accounting of a quantized tree against the same element
    counts at ``cfg.dtype`` width (codes count packed bytes, steps their
    f32 bytes)."""
    dt_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    bits = W_BITS.get(cfg.weight_quant, 8)
    q_bytes = fp_bytes = 0
    for leaf, scale in ((qparams["blocks"]["w_in"],
                         qparams["blocks"]["w_in_s"]),
                        (qparams["blocks"]["w_out"],
                         qparams["blocks"]["w_out_s"]),
                        (qparams["wte"], qparams["wte_s"])):
        n_codes = leaf.numel()
        q_bytes += n_codes + tree_bytes(scale)
        fp_bytes += n_codes * (2 if bits == 4 else 1) * dt_bytes
    return {"weight_bits": bits,
            "quant_weight_bytes": int(q_bytes),
            "fp_weight_bytes": int(fp_bytes),
            "weight_bytes_saved": int(fp_bytes - q_bytes)}

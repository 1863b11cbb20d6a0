"""GPT on one device — port of the single-chip halves of
paddle_tpu/models/gpt.py: the serving path (dense FFN; fp or weight-only
int8/int4 weights, ``cfg.weight_quant``; dense fp or scaled-int8 KV
cache, ``cfg.kv_cache_dtype``) and the dense train step
(``build_spmd_train_step`` on a one-device mesh).

Layouts are the reference's, so a weight conversion is only a dtype
change: weights multiply as ``x @ W`` with ``W`` [D_in, D_out], block
weights stack a leading layer dim [L, ...], caches are
``[L, B, H, S, hd]`` and attention runs on ``[B, H, S, hd]``. The same
parameter tree trains and serves.

Eager PyTorch replaces jit, donation and ``lax.scan``: layers run in a
Python loop, and the KV cache is UPDATED IN PLACE (``cache[l][rows, :,
positions] = ...``) where the reference rebuilt it with
dynamic_update_slice under buffer donation — in place keeps one cache
resident instead of a second [L, B, H, S, hd] copy per step. On the card
``generate()``'s decode steps replay one captured CUDA graph
(``framework.cuda_graph``) where the reference scans them. Training
maps ``jax.checkpoint`` to ``torch.utils.checkpoint`` and
``value_and_grad`` to ``torch.autograd.grad``.

Attention goes through the hand-written kernels: flash-attention forward
for whole-prompt prefill and training (its backward kernels under
autograd), decode attention for every decode tick and every speculative
verify window, Q = k rows a call (its int8 form over a scaled-int8 cache)
(``ops/kernels``); fused AdamW updates the parameters
when ``cfg.fused_adamw`` is set; with ``cfg.weight_quant`` the two FFN
products of every serving block go through the quant_matmul kernel.
Suffix prefill keeps the reference's plain band-masked attention, which
the reference also left to the compiler.

Paged serving (``page_table``/``valid`` on the serving entries): each
layer's cache is a page pool ``[P, H, ps, hd]`` (the stacked leaf ``[L, P,
H, ps, hd]``) and each row reads and writes it through its page table
``[B, nb]``; page 0 is the scratch page that takes the writes of masked
rows (:func:`paged_write`), and decode attention reads through the table
(the paged decode kernels).

Quantized serving (params from ``quantization.quantize_gpt_params``):
the FFN ``w_in``/``w_out`` and ``wte`` are integer codes with ``*_s`` f32
steps, and ``kv_cache_dtype="int8"`` makes each cache the pair ``(codes
int8 [L, B, H, S, hd], steps f32 [L, B, H, S])``, one absmax step per
written position and head. Training ignores ``weight_quant``, as the
reference does.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..framework import prng
from ..framework.cuda_graph import TickGraph, graphed
from ..ops.kernels.decode_attention import decode_attention, paged_view
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.fused_adamw import (fused_adamw_update, tree_flatten,
                                       tree_unflatten)
from ..ops.kernels.primitives import f32_mm
from ..quantization.gpt_quant import (W_BITS, dequant_rows,
                                      kv_cache_quantized, quantize_rows,
                                      wq_einsum)

NEG_INF = -1e30
_BLOCK_KEYS = ("ln1_g", "ln1_b", "w_qkv", "b_qkv", "w_o", "b_o", "ln2_g",
               "ln2_b", "w_in", "b_in", "w_out", "b_out")


@dataclasses.dataclass
class GPTConfig:
    """The dense model, its training schedule and its serving fields."""
    vocab_size: int = 50304
    hidden: int = 2048
    n_layers: int = 24
    n_heads: int = 16
    max_seq: int = 2048
    # kept for the reference's field set: its functional train step, like
    # this one, applies no dropout
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # mesh degrees and MoE: this slice is the dense single-device model
    dp: int = 1
    pp: int = 1
    mp: int = 1
    sp: int = 1
    sharding: int = 1
    ep: int = 1
    moe_experts: int = 0
    # schedule
    micro_batches: int = 1
    # recompute each block on the backward pass (torch.utils.checkpoint)
    remat: bool = True
    # "full" recomputes the whole block; the reference's "dots" policy
    # (save matmul outputs) is not ported yet
    remat_policy: str = "full"
    # > 1 splits the lm-head cross entropy into this many sequence chunks,
    # each recomputed on the backward pass, so the [B, S, V] f32 logits
    # never exist at once
    xent_chunks: int = 1
    # one fused AdamW kernel per leaf (f32 moments only)
    fused_adamw: bool = False
    # AdamW moment dtype; the math runs in f32 either way
    opt_dtype: torch.dtype = torch.float32
    # storage dtype of the K/V cache (None = dtype); the string "int8"
    # selects the scaled-int8 cache (int8 codes + one f32 absmax step per
    # written position per head). Attention math is f32 whatever it is.
    kv_cache_dtype: torch.dtype | str | None = None
    # weight-only quantization of the serving matmul weights (None off;
    # "int8"/"int4": FFN w_in/w_out and wte as integer codes with
    # per-output-channel f32 steps; params from quantize_gpt_params with
    # the matching width). Training ignores it.
    weight_quant: str | None = None
    # keys per block of the plain bounded decode attention; cache lengths
    # round up to a multiple (pad_cache_len)
    decode_block: int = 128
    # > 0: chunked prefill attends in query chunks of this many tokens
    prefill_chunk: int = 0

    def __post_init__(self):
        if self.hidden % self.n_heads:
            raise ValueError(f"hidden {self.hidden} does not split over "
                             f"{self.n_heads} heads")
        if isinstance(self.kv_cache_dtype, str) \
                and self.kv_cache_dtype != "int8":
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r}: the only string "
                "form is 'int8' (the scaled-int8 cache); pass a torch dtype "
                "for a plain narrow cache")
        degrees = {n: getattr(self, n) for n in
                   ("dp", "pp", "mp", "sp", "sharding", "ep")}
        if any(d != 1 for d in degrees.values()) or self.moe_experts:
            raise NotImplementedError(
                f"mesh degrees {degrees}, moe_experts={self.moe_experts}: "
                "the port runs the dense model on one device; MoE and "
                "multi-device parallelism belong to later slices")
        if self.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r}: only 'full' is ported; "
                "the 'dots' policy (save matmul outputs) is a later slice")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads


def gpt3_1p3b(**kw) -> GPTConfig:
    """GPT-3 1.3B: 24 layers, d=2048, 16 heads, bf16."""
    base = dict(vocab_size=50304, hidden=2048, n_layers=24, n_heads=16,
                max_seq=2048)
    base.update(kw)
    return GPTConfig(**base)


def gpt_tiny(**kw) -> GPTConfig:
    base = dict(vocab_size=256, hidden=64, n_layers=4, n_heads=4,
                max_seq=64, dtype=torch.float32)
    base.update(kw)
    return GPTConfig(**base)


# ==========================================================================
# Parameters
# ==========================================================================
def _shapes(cfg: GPTConfig, quantized: bool = False) -> dict:
    """Leaf shapes of the parameter tree; ``quantized``: the tree of
    ``quantize_gpt_params`` at ``cfg.weight_quant`` (int4 codes packed
    along the contraction axis, plus the ``*_s`` steps)."""
    D, V, L = cfg.hidden, cfg.vocab_size, cfg.n_layers
    shapes = {"wte": (V, D), "wpe": (cfg.max_seq, D), "lnf_g": (D,),
              "lnf_b": (D,),
              "blocks": {"ln1_g": (L, D), "ln1_b": (L, D),
                         "w_qkv": (L, D, 3 * D), "b_qkv": (L, 3 * D),
                         "w_o": (L, D, D), "b_o": (L, D),
                         "ln2_g": (L, D), "ln2_b": (L, D),
                         "w_in": (L, D, 4 * D), "b_in": (L, 4 * D),
                         "w_out": (L, 4 * D, D), "b_out": (L, D)}}
    if quantized:
        pack = 2 if _wq_bits(cfg) == 4 else 1
        blocks = shapes["blocks"]
        blocks.update({"w_in": (L, D // pack, 4 * D), "w_in_s": (L, 4 * D),
                       "w_out": (L, 4 * D // pack, D), "w_out_s": (L, D)})
        shapes.update({"wte": (V, D // pack), "wte_s": (V,)})
    return shapes


# leaves of a quantized tree that keep their own dtype: int8 codes, f32 steps
_QUANT_LEAVES = ("w_in", "w_out", "wte", "w_in_s", "w_out_s", "wte_s")


# elements of one f32 draw: a leaf is drawn this many at a time (one
# layer of a [L, ...] leaf whenever a layer is larger)
_DRAW_ELEMS = 1 << 24
# the reference's key of each drawn leaf: split(PRNGKey(seed), 10)[i]
_INIT_KEYS = {"wte": 0, "wpe": 1, "w_qkv": 2, "w_o": 3, "w_in": 4,
              "w_out": 5}


def init_leaf(key, shape, cfg: GPTConfig, device, div=None,
              rows=None) -> torch.Tensor:
    """One matrix leaf as the reference draws it: ``normal(key, shape) *
    0.02`` in f32, cast to ``cfg.dtype``, then divided by ``div`` in
    ``cfg.dtype`` (a true division by a 0-dim tensor). Drawn a block of
    leading rows at a time (a layer of an [L, ...] leaf) through the
    counter offset, so memory holds one block's f32 draw. ``rows``: only
    those leading rows (a ``range``), e.g. one layer."""
    rows = range(shape[0]) if rows is None else rows
    row = math.prod(shape[1:])
    per = max(1, _DRAW_ELEMS // max(row, 1))
    out = torch.empty((len(rows), *shape[1:]), dtype=cfg.dtype,
                      device=device)
    divisor = (None if div is None else
               torch.tensor(div, dtype=cfg.dtype, device=device))
    for i in range(0, len(rows), per):
        r0, r1 = rows[i], rows[min(i + per, len(rows)) - 1] + 1
        x = (prng.normal(key, (r1 - r0, *shape[1:]), device=device,
                         offset=r0 * row) * 0.02).to(cfg.dtype)
        out[i:i + r1 - r0] = x if divisor is None else x / divisor
    return out


def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> dict:
    """The reference's weights, bit for bit: ``ks = split(PRNGKey(seed),
    10)``; wte, wpe, w_qkv, w_o, w_in and w_out are ``normal(ks[i]) *
    0.02`` (keys 0-5) cast to ``cfg.dtype``, w_o and w_out then divided
    by sqrt(2L); unit LayerNorm gains, zero biases. jax's threefry and
    ``normal`` are ported bit for bit (``framework.prng``), so a seed
    gives the same weights on every device. Each leaf is drawn one layer
    (or 2^24 elements) at a time (:func:`init_leaf`)."""
    dev = resolve_device(device)
    ks = prng.split(prng.PRNGKey(seed), 10)
    L = cfg.n_layers
    div = math.sqrt(2 * L)
    shapes = _shapes(cfg)
    blocks = {}
    for name, shape in shapes["blocks"].items():
        if name.startswith("ln") and name.endswith("_g"):
            blocks[name] = torch.ones(shape, dtype=cfg.dtype, device=dev)
        elif name.startswith(("b_", "ln")):
            blocks[name] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        else:
            blocks[name] = init_leaf(
                ks[_INIT_KEYS[name]], shape, cfg, dev,
                div if name in ("w_o", "w_out") else None)
    return {"wte": init_leaf(ks[0], shapes["wte"], cfg, dev),
            "wpe": init_leaf(ks[1], shapes["wpe"], cfg, dev),
            "blocks": blocks,
            "lnf_g": torch.ones(shapes["lnf_g"], dtype=cfg.dtype, device=dev),
            "lnf_b": torch.zeros(shapes["lnf_b"], dtype=cfg.dtype,
                                 device=dev)}


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)   # a writable, contiguous copy torch may alias
    if a.dtype.name == "bfloat16":
        # torch.from_numpy has no bf16: carry the bits over as uint16
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, cfg: GPTConfig, device=None) -> dict:
    """Carry a parameter tree of numpy arrays (e.g. the reference's
    ``jax.device_get(init_params(...))``, bf16 included) over to torch
    tensors in ``cfg.dtype`` on ``device``. A weight-only quantized tree
    (the reference's ``quantize_gpt_params`` output: it has ``wte_s``)
    keeps its int8 codes as int8 and its ``*_s`` steps as f32, at the
    shapes of ``cfg.weight_quant``."""
    dev = resolve_device(device)
    quantized = "wte_s" in tree
    if quantized and not cfg.weight_quant:
        raise ValueError("a quantized parameter tree (it has wte_s) needs "
                         "cfg.weight_quant set to its width")
    shapes = _shapes(cfg, quantized)

    def conv(a, shape, name):
        t = _to_torch(a, dev)
        want = ((torch.float32 if name.endswith("_s") else torch.int8)
                if quantized and name in _QUANT_LEAVES else cfg.dtype)
        if quantized and want == torch.int8 and t.dtype != torch.int8:
            raise ValueError(f"param {name}: quantized codes must be int8, "
                             f"got {t.dtype}")
        t = t.to(want)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {tuple(t.shape)}, "
                             f"config wants {tuple(shape)}")
        return t

    out = {k: conv(tree[k], shapes[k], k) for k in shapes if k != "blocks"}
    out["blocks"] = {k: conv(tree["blocks"][k], shape, k)
                     for k, shape in shapes["blocks"].items()}
    return out


def layer_params(params: dict) -> list[dict]:
    """Per-layer views of the stacked block weights. ``unbind`` gives all
    layers at once, so under autograd each stacked leaf gets one gradient
    (a stack of the layers'), not one full-size zero-padded add per layer."""
    blocks = params["blocks"]
    keys = _BLOCK_KEYS + tuple(k for k in ("w_in_s", "w_out_s")
                               if k in blocks)
    per_key = [blocks[k].unbind(0) for k in keys]
    return [dict(zip(keys, views)) for views in zip(*per_key)]


def check_params_device(params: dict, device: torch.device) -> None:
    have = params["wte"].device
    if have.type != device.type or (
            device.index is not None and have.index != device.index):
        raise ValueError(f"params live on {have}, the call runs on "
                         f"{device}: move them with params_from_numpy or "
                         "init_params(device=...)")


# ==========================================================================
# Serving forward pieces
# ==========================================================================
def _layer_norm(x, g, b, eps=1e-5):
    """Statistics in f32, normalise, cast to x's dtype, THEN scale and
    shift in that dtype (the reference's order)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def _wq_bits(cfg: GPTConfig) -> int:
    if cfg.weight_quant not in W_BITS:
        raise ValueError(
            f"cfg.weight_quant={cfg.weight_quant!r} unknown: expected "
            "None, 'int8' or 'int4'")
    return W_BITS[cfg.weight_quant]


def _take_wte(params, idx, cfg: GPTConfig):
    """Embedding rows for the serving paths. A quantized wte gathers only
    the codes and multiplies by the per-row steps after (f32 rows)."""
    if not cfg.weight_quant:
        return params["wte"][idx]
    return dequant_rows(params["wte"][idx], params["wte_s"][idx],
                        _wq_bits(cfg), pack_axis=-1)


def _ffn_dense(x, h, p):
    """The fp FFN tail: ``x + ffn(h) + b_out`` with tanh GELU."""
    ff = h @ p["w_in"] + p["b_in"]
    ff = F.gelu(ff, approximate="tanh")
    return x + ff @ p["w_out"] + p["b_out"]


def _ffn_serving(x, h, p, cfg: GPTConfig):
    """The FFN tail of the serving blocks. Quantized: both products run on
    the integer codes through ``wq_einsum`` (the quant_matmul kernel),
    f32 out, cast back to h's dtype before the bias."""
    if not cfg.weight_quant:
        return _ffn_dense(x, h, p)
    bits = _wq_bits(cfg)
    ff = wq_einsum("bsd,de->bse", h, p["w_in"], p["w_in_s"],
                   bits).to(h.dtype) + p["b_in"]
    ff = F.gelu(ff, approximate="tanh")
    return x + wq_einsum("bse,ed->bsd", ff, p["w_out"], p["w_out_s"],
                         bits).to(h.dtype) + p["b_out"]


class _LMHead(torch.autograd.Function):
    """The f32-output lm-head (:func:`f32_mm`: [N, D] x [V, D]^T -> [N, V]
    f32, operands in the params' dtype) with a backward of plain matmuls
    (the f32 output form of ``torch.mm`` need not have one). The reference's
    transpose multiplies the f32 logit gradient by the bf16 weights in
    f32; on the card a bf16 model rounds that gradient to bf16 first, so
    both products run on the bf16 tensor cores with f32 accumulation
    instead of as f32 CUDA-core GEMMs. f32 models and the CPU keep f32."""

    @staticmethod
    def forward(ctx, x2, wte):
        ctx.save_for_backward(x2, wte)
        return f32_mm(x2, wte.t())

    @staticmethod
    def backward(ctx, g):
        x2, wte = ctx.saved_tensors
        if x2.dtype == torch.float32 or x2.device.type != "cuda":
            gx = (g @ wte.float()).to(x2.dtype)
            gw = (g.t() @ x2.float()).to(wte.dtype)
        else:
            g16 = g.to(x2.dtype)
            gx, gw = g16 @ wte, g16.t() @ x2
        return gx, gw


def _lm_head(x, wte):
    """Tied vocab projection, [B, S, D] -> [B, S, V] f32, differentiable
    through :class:`_LMHead`."""
    out = _LMHead.apply(x.reshape(-1, x.shape[-1]), wte)
    return out.reshape(*x.shape[:-1], wte.shape[0])


def _lm_logits(x, params, cfg: GPTConfig):
    """The serving lm-head: :func:`_lm_head`, or with ``cfg.weight_quant``
    the plain product on the wte codes scaled by the per-row steps."""
    if cfg.weight_quant:
        return wq_einsum("bsd,vd->bsv", x, params["wte"], params["wte_s"],
                         _wq_bits(cfg), pack_axis=-1)
    return _lm_head(x, params["wte"])


def _split_qkv(qkv, cfg: GPTConfig):
    """[B, S, 3D] -> q, k, v [B, H, S, hd]; the columns are interleaved
    (head, 3, head_dim) as in the reference's Megatron layout."""
    B, S = qkv.shape[:2]
    qkv = qkv.view(B, S, cfg.n_heads, 3, cfg.head_dim)
    return tuple(qkv[:, :, :, i].transpose(1, 2) for i in range(3))


# --------------------------------------------------------------------------
# Scaled-int8 KV cache: a quantized cache is the PAIR (codes int8 [..., S,
# hd], steps f32 [..., S]); the helpers below are the only code that looks
# inside.
# --------------------------------------------------------------------------
def kv_data(cache):
    """The storage tensor of a (possibly quantized) cache, for shapes."""
    return cache[0] if isinstance(cache, tuple) else cache


def kv_dequant(cache, dtype=torch.float32):
    """Whole-buffer dequantization (the suffix prefill's band attention;
    decode dequantizes inside decode_attention instead)."""
    if isinstance(cache, tuple):
        q, s = cache
        return (q.float() * s[..., None]).to(dtype)
    return cache.to(dtype)


def _kv_index(cache, idx):
    """``cache[idx]`` of a cache or of a scaled-int8 pair (codes and steps
    together): a layer's view of the stacked cache, or a layer's rows."""
    if isinstance(cache, tuple):
        return tuple(c[idx] for c in cache)
    return cache[idx]


def _kv_write(cache, new, pos, valid=None):
    """Write ``new`` [B, H, Q, hd] into ``cache`` [B, H, S, hd] (or the
    scaled-int8 pair: codes and per-position steps) in place, row b at
    positions ``pos[b] .. pos[b] + Q - 1`` (a start past ``S - Q`` clamps
    to it, as dynamic_update_slice does). ``valid`` ([B] bool): rows that
    are False keep what their cache holds there."""
    data = kv_data(cache)
    B, Q, S = new.shape[0], new.shape[2], data.shape[2]
    start = pos.clamp(0, S - Q)
    cols = start[:, None] + torch.arange(Q, device=data.device)[None, :]
    rows = torch.arange(B, device=data.device)[:, None]

    def put(leaf, vals):
        # advanced indices on dims 0 and 2 put [B, Q] first: [B, Q, H(, hd)]
        if valid is not None:
            m = valid.view((B,) + (1,) * (vals.dim() - 1))
            vals = torch.where(m, vals, leaf[rows, :, cols])
        leaf[rows, :, cols] = vals

    if isinstance(cache, tuple):
        q, s = quantize_rows(new)
        put(data, q.permute(0, 2, 1, 3))
        put(cache[1], s.permute(0, 2, 1))
        return
    put(data, new.permute(0, 2, 1, 3).to(data.dtype))


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int | None = None,
                  device=None):
    """Zeroed K and V caches [L, B, H, S, hd] in cfg.kv_cache_dtype (cfg.dtype
    when unset). ``kv_cache_dtype="int8"`` gives each as the pair ``(codes
    int8 [L, B, H, S, hd], steps f32 [L, B, H, S])``; zero steps
    dequantize to the zeros of a fresh fp cache."""
    dev = resolve_device(device)
    s = max_len or cfg.max_seq
    shape = (cfg.n_layers, batch, cfg.n_heads, s, cfg.head_dim)
    if kv_cache_quantized(cfg):
        mk = lambda: (torch.zeros(shape, dtype=torch.int8, device=dev),
                      torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=dev))
        return mk(), mk()
    dt = cfg.kv_cache_dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


# --------------------------------------------------------------------------
# Paged KV cache (block tables, Kwon et al. SOSP'23): the cache is a page
# pool, per layer [P, H, ps, hd], and each row owns an int32 page table
# [nb] mapping logical page i (positions [i*ps, (i+1)*ps)) to a pool page.
# Page 0 is the scratch page: never granted to a row, it takes the writes
# of dead and masked rows (table entries default to 0), so a frozen row's
# write never lands on a page another row shares. These helpers are the
# only code that turns (position, table) into pool coordinates.
# --------------------------------------------------------------------------
# pool leaf [P, H, ps(, hd)] + table [B, nb] -> [B, H, nb*ps(, hd)]
paged_gather = paged_view


def page_index(pos, n, page_table, ps, valid=None):
    """Pool coordinates of absolute positions ``pos[b] + [0, n)`` through
    the page table [B, nb]: (page, offset), each [B, n]; valid: [B] or
    [B, n] bool — masked-off positions map to the scratch page 0. The
    serving forwards compute it once and every layer's K and V leaves
    write there (one index store each, as the dense cache's)."""
    ap = pos[:, None] + torch.arange(n, device=pos.device)[None, :]  # [B, n]
    pgi = (ap // ps).clamp(0, page_table.shape[1] - 1)
    pg = torch.gather(page_table.long(), 1, pgi)
    if valid is not None:
        m = valid if valid.dim() == 2 else valid[:, None]
        pg = torch.where(m, pg, torch.zeros_like(pg))
    return pg, ap % ps


def _page_put(c, vals, index):
    """Store vals [B, H, n(, hd)] into one pool leaf [P, H, ps(, hd)] in
    place at the :func:`page_index` coordinates."""
    pg, off = index
    # advanced indices on dims 0 and 2 put [B, n] first: value [B, n, H(, hd)]
    c[pg, :, off] = vals.movedim(1, 2).to(c.dtype)


def _page_scatter(c, vals, pos, page_table, valid=None):
    """Write new per-row values into ONE pool leaf in place, through the
    page table. c: [P, H, ps(, hd)]; vals: [B, H, n(, hd)] for absolute
    positions ``pos[b] + [0, n)``; valid: [B] or [B, n] bool — masked-off
    writes go to the scratch page 0."""
    _page_put(c, vals, page_index(pos, vals.shape[2], page_table, c.shape[2],
                                  valid))


def paged_write(cache, new, pos=None, page_table=None, valid=None,
                index=None):
    """The paged counterpart of :func:`_kv_write`: write ``new`` [B, H, n,
    hd] at per-row positions ``pos`` [B] through the page table, in place;
    a scaled-int8 pool writes codes and steps at the same coordinates.
    ``index``: those coordinates from :func:`page_index`, when the caller
    computed them once for all layers."""
    if index is None:
        index = page_index(pos, new.shape[2], page_table,
                           kv_data(cache).shape[2], valid)
    if isinstance(cache, tuple):
        q, s = quantize_rows(new)
        _page_put(cache[0], q, index)
        _page_put(cache[1], s, index)
        return
    _page_put(cache, new, index)


def _block_decode(x, p, cfg: GPTConfig, k_cache, v_cache, pos,
                  page_table=None, index=None, valid=None):
    """One block on a window of new positions. x: [B, Q, D]; k/v_cache:
    this layer's [B, H, S, hd] or scaled-int8 pair (written in place);
    pos: [B] position of window row 0. Row j attends keys <= pos + j.
    ``page_table`` makes the caches this layer's page pools: the window
    writes at the :func:`page_index` coordinates ``index`` and attention
    reads through the table. ``valid`` ([B] bool, dense caches): rows
    that are False write nothing and attend what the cache holds."""
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    q, k_new, v_new = _split_qkv(h @ p["w_qkv"] + p["b_qkv"], cfg)
    if page_table is not None:
        paged_write(k_cache, k_new, index=index)
        paged_write(v_cache, v_new, index=index)
    else:
        _kv_write(k_cache, k_new, pos, valid)
        _kv_write(v_cache, v_new, pos, valid)
    attn = decode_attention(q, k_cache, v_cache, pos,
                            block=cfg.decode_block,
                            page_table=page_table).to(x.dtype)
    B, Q = x.shape[:2]
    attn = attn.transpose(1, 2).reshape(B, Q, -1)
    x = x + attn @ p["w_o"] + p["b_o"]
    h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    return _ffn_serving(x, h, p, cfg)


def _positions(pos, batch: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, device=device).long()
    return pos.expand(batch) if pos.dim() == 0 else pos


def _decode_window(params, cfg: GPTConfig, tokens, pos, k_cache, v_cache,
                   page_table=None, valid=None):
    """The serving forward of a window of Q new tokens per row. tokens:
    [B, Q] int; pos: int or [B] int, the position of window row 0. Writes
    the window's K/V at ``[pos, pos + Q)`` of every layer in place and
    returns the logits [B, Q, V] f32. Positions past ``cfg.max_seq`` clip
    to the last positional embedding (only window rows past the logical
    cache limit reach them, and acceptance never takes their logits).
    ``page_table``/``valid``: the paged pool layout (masked rows write the
    scratch page); ``valid`` on a dense cache: masked rows write
    nothing."""
    B, Q = tokens.shape
    pos = _positions(pos, B, tokens.device)
    posq = pos[:, None] + torch.arange(Q, device=tokens.device)[None, :]
    emb = _take_wte(params, tokens, cfg) \
        + params["wpe"][posq.clamp(0, cfg.max_seq - 1)]
    x = emb.to(cfg.dtype)
    index = None if page_table is None else page_index(
        pos, Q, page_table, kv_data(k_cache).shape[3], valid)
    for i, lp in enumerate(layer_params(params)):
        x = _block_decode(x, lp, cfg, _kv_index(k_cache, i),
                          _kv_index(v_cache, i), pos, page_table, index,
                          valid if page_table is None else None)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return _lm_logits(x, params, cfg)


def decode_one_token(params, cfg: GPTConfig, token, pos, k_cache, v_cache,
                     page_table=None, valid=None):
    """token: [B] int; pos: int or [B] int positions. Writes this token's
    K/V into the caches in place and returns (logits [B, V] f32,
    k_cache, v_cache). ``page_table``/``valid``: the paged pool layout
    (see :func:`_block_decode`); ``valid`` on a dense cache keeps masked
    rows' cache as it is."""
    logits = _decode_window(params, cfg, token[:, None], pos, k_cache,
                            v_cache, page_table, valid)
    return logits[:, 0], k_cache, v_cache


def _attend_prefill(q, k, v, chunk: int):
    """Causal attention over the whole prompt, q/k/v [B, H, P, hd]: one
    flash call, or (chunk > 0) query chunks each attending its key
    prefix [0, chunk_end) — the bottom-right causal alignment covers
    Sq < Skv."""
    P = q.shape[2]
    if chunk <= 0 or chunk >= P:
        return flash_attention(q, k, v, None, True)
    outs = []
    for c0 in range(0, P, chunk):
        c1 = min(c0 + chunk, P)
        outs.append(flash_attention(q[:, :, c0:c1].contiguous(),
                                    k[:, :, :c1].contiguous(),
                                    v[:, :, :c1].contiguous(), None, True))
    return torch.cat(outs, dim=2)


def _block_prefill(x, p, cfg: GPTConfig, k_cache, v_cache, chunk: int,
                   rows, index=None):
    """One block over the whole prompt. x: [n, P, D]; k/v_cache: this
    layer's [B, H, S, hd] or scaled-int8 pair; rows: [n] cache rows the
    prompts own (their positions [0, P) are written in place). ``index``
    (the :func:`page_index` coordinates of positions [0, P)) makes the
    caches page pools written there instead."""
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    q, k_new, v_new = _split_qkv(h @ p["w_qkv"] + p["b_qkv"], cfg)
    P = x.shape[1]
    if isinstance(k_cache, tuple):
        # quantize the prompt K/V once, write codes and steps, and attend
        # over the ROUND-TRIPPED values, exactly what decode will re-read
        atts = []
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            codes, steps = quantize_rows(new)
            if index is not None:
                _page_put(cache[0], codes, index)
                _page_put(cache[1], steps, index)
            else:
                cache[0][rows, :, :P] = codes
                cache[1][rows, :, :P] = steps
            atts.append((codes.float() * steps[..., None]).to(
                q.dtype).contiguous())
        k_att, v_att = atts
    else:
        if index is not None:
            _page_put(k_cache, k_new, index)
            _page_put(v_cache, v_new, index)
        else:
            k_cache[rows, :, :P] = k_new.to(k_cache.dtype)
            v_cache[rows, :, :P] = v_new.to(v_cache.dtype)
        # attend over the cache-rounded K/V, the values decode will re-read
        k_att = k_new.to(k_cache.dtype).to(q.dtype).contiguous()
        v_att = v_new.to(v_cache.dtype).to(q.dtype).contiguous()
    attn = _attend_prefill(q.contiguous(), k_att, v_att, chunk).to(x.dtype)
    attn = attn.transpose(1, 2).reshape(x.shape[0], P, -1)
    x = x + attn @ p["w_o"] + p["b_o"]
    h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    return _ffn_serving(x, h, p, cfg)


def _row_len(k_cache, page_table) -> int:
    """Positions a cache row holds: the cache length, or a paged row's
    pages_per_row * page_size (the pool leaf is [L, P, H, ps, hd])."""
    ps = kv_data(k_cache).shape[3]
    return ps if page_table is None else page_table.shape[1] * ps


def prefill(params, cfg: GPTConfig, tokens, k_cache, v_cache, lengths=None,
            mode: str = "full", rows=None, page_table=None, valid=None):
    """Single-pass batched prefill. tokens: [n, P] right-padded;
    lengths: [n] true lengths (None = P); rows: [n] cache rows to write
    (None = rows 0..n-1 of the caches). Positions past a row's length
    hold garbage K/V, never read: decode starts at the row's length and
    overwrites before reading. ``page_table`` ([n, nb], the prompts'
    tables) and ``valid`` ([n] bool) select the paged pool layout, which
    needs no ``rows``. Returns (logits [n, V] f32 at each row's last real
    position, k_cache, v_cache)."""
    n, P = tokens.shape
    dev = tokens.device
    if P > _row_len(k_cache, page_table):
        raise ValueError(f"prompt width {P} exceeds the cache length "
                         f"{_row_len(k_cache, page_table)}")
    chunk = cfg.prefill_chunk if mode == "chunked" else 0
    if mode == "chunked" and cfg.prefill_chunk <= 0:
        raise ValueError(
            "PADDLE_TPU_PREFILL_MODE=chunked needs cfg.prefill_chunk > 0 "
            "(tokens per prefill chunk)")
    rows = (torch.arange(n, device=dev) if rows is None
            else torch.as_tensor(rows, device=dev).long())
    x = (_take_wte(params, tokens, cfg) + params["wpe"][:P]).to(cfg.dtype)
    index = None if page_table is None else page_index(
        torch.zeros((n,), dtype=torch.long, device=dev), P, page_table,
        kv_data(k_cache).shape[3], valid)
    for i, lp in enumerate(layer_params(params)):
        x = _block_prefill(x, lp, cfg, _kv_index(k_cache, i),
                           _kv_index(v_cache, i), chunk, rows, index)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    if lengths is None:
        last = x[:, P - 1]
    else:
        idx = (torch.as_tensor(lengths, device=dev).long() - 1).clamp(0, P - 1)
        last = x[torch.arange(n, device=dev), idx]
    return _lm_logits(last[:, None], params, cfg)[:, 0], k_cache, v_cache


def _block_prefill_suffix(x, p, cfg: GPTConfig, k_cache, v_cache, starts,
                          shifts, page_table=None, index=None, valid=None):
    """One block over a suffix chunk at per-row cache offsets. x: [B, C, D]
    (row r's real tokens sit at window indices [shifts[r], C)); the
    window [starts[r], starts[r] + C) of cache row r is written in place,
    except indices below shifts[r], which keep the resident prefix (a
    window slid left near the cache end must not clobber it), and except
    rows where ``valid`` ([B] bool) is False, which rewrite their own
    bytes (the reference's ``_merge_kv`` keeps them, without copying the
    whole cache). A scaled-int8 cache merges its codes AND its
    per-position steps the same way: a resident position keeps the step
    its codes were written with. Each query attends the WHOLE cache row
    under a band mask (key j visible iff j <= its absolute position).

    With ``page_table`` ([B, nb]) the caches are page pools written at
    the :func:`page_index` coordinates ``index`` (its mask holds the shift
    and ``valid``: masked writes land on the scratch page, and a shared
    prefix page, always below the offset, is never touched); the band
    attention reads the gathered whole-row view."""
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    q, k_new, v_new = _split_qkv(h @ p["w_qkv"] + p["b_qkv"], cfg)
    C = x.shape[1]
    ar = torch.arange(C, device=x.device)
    if page_table is not None:
        paged_write(k_cache, k_new, index=index)
        paged_write(v_cache, v_new, index=index)
        k_att = kv_dequant(paged_gather(k_cache, page_table), q.dtype)
        v_att = kv_dequant(paged_gather(v_cache, page_table), q.dtype)
        return _suffix_attend(x, p, cfg, q, k_att, v_att, starts, C)
    cols = starts[:, None] + ar[None, :]                        # [B, C]
    keep_new = ar[None, :] >= shifts[:, None]
    if valid is not None:
        keep_new = keep_new & valid[:, None]
    keep_new = keep_new[:, :, None, None]
    r = torch.arange(x.shape[0], device=x.device)[:, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        if isinstance(cache, tuple):
            codes, steps = quantize_rows(new)
            data, st = cache
            data[r, :, cols] = torch.where(
                keep_new, codes.permute(0, 2, 1, 3), data[r, :, cols])
            st[r, :, cols] = torch.where(
                keep_new[..., 0], steps.permute(0, 2, 1), st[r, :, cols])
            continue
        cur = cache[r, :, cols]                                 # [B, C, H, hd]
        cache[r, :, cols] = torch.where(
            keep_new, new.permute(0, 2, 1, 3).to(cache.dtype), cur)
    # one round trip through the cache storage, as in _block_prefill
    k_att = kv_dequant(k_cache, q.dtype)
    v_att = kv_dequant(v_cache, q.dtype)
    return _suffix_attend(x, p, cfg, q, k_att, v_att, starts, C)


def _suffix_attend(x, p, cfg: GPTConfig, q, k_att, v_att, starts, C):
    """Band-masked whole-row attention + FFN tail of the suffix prefill
    (plain PyTorch, like the reference's einsum form)."""
    n = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = torch.matmul(q.float(), k_att.float().transpose(-1, -2)) * scale
    S = k_att.shape[2]
    qpos = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    visible = torch.arange(S, device=x.device)[None, None, :] \
        <= qpos[:, :, None]                                     # [n, C, S]
    scores = torch.where(visible[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    attn = torch.matmul(probs, v_att).to(x.dtype)
    attn = attn.transpose(1, 2).reshape(n, C, -1)
    x = x + attn @ p["w_o"] + p["b_o"]
    h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    return _ffn_serving(x, h, p, cfg)


def prefill_suffix(params, cfg: GPTConfig, tokens, k_cache, v_cache,
                   offsets, lengths=None, page_table=None, valid=None):
    """Suffix-only prefill: run the forward over a chunk of new prompt
    tokens whose K/V prefix is already resident (chunked prefill, one
    chunk per serving tick), over every row of the caches. tokens: [B, C]
    right-padded; offsets: [B] absolute start positions; lengths: [B]
    true token counts (None = C); ``valid`` ([B] bool): rows that are
    False write nothing (dense: they rewrite their own bytes; paged: the
    scratch page), so a serving tick runs the whole slot batch at fixed
    shapes and masks the rows it admits.

    A chunk whose window [offset, offset + C) would run past the cache
    slides left to start = S - C; its tokens roll right by shift =
    offset - start inside the window and the write keeps the resident
    K/V below shift, so the real tokens land at their absolute
    positions. ``page_table`` ([B, nb]) selects the paged pool layout; a
    paged row's length is nb * ps. Returns (logits [B, V] f32 at each
    row's last real position, k_cache, v_cache)."""
    n, C = tokens.shape
    dev = tokens.device
    S = _row_len(k_cache, page_table)
    if C > S:
        raise ValueError(f"chunk width {C} exceeds the cache length {S}")
    offsets = torch.as_tensor(offsets, device=dev).long()
    starts = offsets.clamp(max=S - C)
    shifts = offsets - starts
    ar = torch.arange(C, device=dev)
    # roll each row right by its shift (jnp.roll per row)
    tokens = torch.gather(tokens, 1, (ar[None, :] - shifts[:, None]) % C)
    pos_ids = (starts[:, None] + ar[None, :]).clamp(0, cfg.max_seq - 1)
    x = (_take_wte(params, tokens, cfg) + params["wpe"][pos_ids]).to(cfg.dtype)
    index = None
    if page_table is not None:
        wmask = ar[None, :] >= shifts[:, None]                  # [B, C]
        if valid is not None:
            wmask = wmask & valid[:, None]
        index = page_index(starts, C, page_table, kv_data(k_cache).shape[3],
                           wmask)
    for i, lp in enumerate(layer_params(params)):
        x = _block_prefill_suffix(x, lp, cfg, _kv_index(k_cache, i),
                                  _kv_index(v_cache, i), starts, shifts,
                                  page_table, index, valid)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    lengths = (torch.full((n,), C, device=dev, dtype=torch.long)
               if lengths is None
               else torch.as_tensor(lengths, device=dev).long())
    idx = (shifts + lengths - 1).clamp(0, C - 1)
    last = x[torch.arange(n, device=dev), idx]
    return _lm_logits(last[:, None], params, cfg)[:, 0], k_cache, v_cache


def check_prefill_mode(mode: str) -> str:
    """The prefill modes of this slice: 'full' (one batched forward) and
    'chunked' (cfg.prefill_chunk-token attention tiles). The reference's
    per-token 'scan' A/B mode is not ported."""
    if mode not in ("full", "chunked"):
        raise ValueError(
            f"prefill mode {mode!r} unknown: expected 'full' (one batched "
            "forward) or 'chunked' (cfg.prefill_chunk-token tiles)")
    return mode


def pad_cache_len(n: int, block: int) -> int:
    """Round a cache length up to a decode_block multiple (lengths <=
    block stay as they are)."""
    if block <= 0 or n <= block or n % block == 0:
        return n
    return -(-n // block) * block


def filtered_probs(logits, temperature, top_k=0, top_p=0.0):
    """The post-filter next-token distribution, f32 over the full vocab:
    temperature, then top-k, then top-p over the renormalised post-top-k
    distribution; filtered entries are exactly 0. Rows with temperature
    <= 0 get the one-hot of their argmax. ``temperature`` may be a
    scalar or a per-row tensor."""
    lg = logits.float()
    if torch.is_tensor(temperature):
        t = temperature.to(device=lg.device, dtype=torch.float32).expand(
            lg.shape[:-1])
    else:   # a fill: a host-to-device copy would wait for the card
        t = torch.full(lg.shape[:-1], float(temperature),
                       dtype=torch.float32, device=lg.device)
    greedy = t <= 0.0
    lg = lg / torch.where(greedy, torch.ones_like(t), t)[..., None]
    if top_k > 0 or top_p > 0.0:
        desc = torch.sort(lg, dim=-1, descending=True).values
        if top_k > 0:
            kth = desc[..., top_k - 1:top_k]
            lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
        if top_p > 0.0:
            desc_f = desc
            if top_k > 0:
                rank = torch.arange(desc.shape[-1], device=lg.device)
                desc_f = torch.where(rank < top_k, desc,
                                     torch.full_like(desc, -math.inf))
            probs = torch.softmax(desc_f, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = cum - probs < top_p          # mass BEFORE this token
            cutoff = torch.where(keep, desc, torch.full_like(desc, math.inf)
                                 ).amin(dim=-1, keepdim=True)
            lg = torch.where(lg < cutoff, torch.full_like(lg, NEG_INF), lg)
    probs = torch.softmax(lg, dim=-1)
    onehot = F.one_hot(lg.argmax(-1), lg.shape[-1]).float()
    return torch.where(greedy[..., None], onehot, probs)


def sample_logits(logits, key=None, temperature=0.0, top_k=0, top_p=0.0):
    """Greedy argmax at temperature 0 (``key`` unused, nothing launched
    beyond the argmax), else one draw per row from :func:`filtered_probs`
    with the threefry ``key`` (a :mod:`..framework.prng` pair):
    ``categorical(key, log(probs))``, the reference's draw bit for bit.
    log(0) = -inf marks filtered-out tokens."""
    if temperature == 0.0:
        return logits.argmax(-1)
    probs = filtered_probs(logits, temperature, top_k, top_p)
    return prng.categorical(key, torch.log(probs))


# ==========================================================================
# Speculative decoding: draft-propose, one k-wide verify, acceptance
# ==========================================================================
def verify_tokens(params, cfg: GPTConfig, tokens, pos, k_cache, v_cache,
                  page_table=None, valid=None):
    """The speculative verify forward: score a k-token window in one
    forward. tokens: [B, k] int (window row 0 is the target's own token,
    rows 1.. the draft's proposals); pos: int or [B], the cache position
    of window row 0. Writes the window's K/V at ``[pos, pos + k)`` of
    every layer in place and returns (logits [B, k, V] f32, the target's
    next-token distribution after each window position, k_cache,
    v_cache). Window row j attends keys ``<= pos + j`` through the decode
    kernel at Q = k (:data:`~..ops.kernels.decode_attention.MAX_Q` rows at
    most). The wpe index clips to ``max_seq - 1``: only rows past the
    logical cache limit reach it, and acceptance never takes them."""
    return (_decode_window(params, cfg, tokens, pos, k_cache, v_cache,
                           page_table, valid), k_cache, v_cache)


def early_exit_draft(params, cfg: GPTConfig, n_layers: int):
    """Self-speculation draft: the target's first ``n_layers`` layers with
    the shared final norm and lm-head, as a model of its own. Returns
    ``(draft_params, draft_cfg)``; the blocks are views of the target's
    (no copy), and the draft's layer caches are the target's first
    ``n_layers`` layer caches."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(
            f"early-exit draft cut {n_layers} must be in "
            f"[1, {cfg.n_layers}] (the target's layer count)")
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    dparams = {"wte": params["wte"], "wpe": params["wpe"],
               "blocks": {k: v[:n_layers]
                          for k, v in params["blocks"].items()},
               "lnf_g": params["lnf_g"], "lnf_b": params["lnf_b"]}
    if cfg.weight_quant:
        # a quantized wte rides with its per-row steps
        dparams["wte_s"] = params["wte_s"]
    return dparams, dcfg


def check_draft_compat(cfg: GPTConfig, draft_cfg: GPTConfig) -> None:
    """A separate draft must speak the target's token space and cover its
    positions; a mismatch is a construction-time error (a vocab mismatch
    would accept proposals whose ids merely collide)."""
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft/target vocab mismatch: draft vocab_size "
            f"{draft_cfg.vocab_size} != target {cfg.vocab_size} — "
            "speculative proposals are token ids, the two models must "
            "share one vocabulary")
    if draft_cfg.max_seq < cfg.max_seq:
        raise ValueError(
            f"draft max_seq {draft_cfg.max_seq} < target {cfg.max_seq}: "
            "the draft must have positional embeddings for every position "
            "the target can decode")


def _take_along(x, idx):
    """``x[b, idx[b]]`` over dim 1: x [B, k, ...], idx [B] int."""
    g = idx.view((-1, 1) + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], 1) + tuple(x.shape[2:]))
    return torch.gather(x, 1, g)[:, 0]


def greedy_acceptance(props, verify_logits, pos, can, limit,
                      eos_token_id=None):
    """Greedy speculative acceptance, per row. props: [B, k] the verified
    window (row 0 the target's own greedy token, always accepted for live
    rows); verify_logits: [B, k, V] from :func:`verify_tokens`; pos: [B]
    the window's first position; can: [B] bool, rows allowed to decode;
    limit: the logical cache length.

    Window index j is accepted iff every earlier index was, the target's
    greedy choice after index j-1 equals it, no earlier accepted token was
    eos, and ``pos + j < limit``: the accepted prefix is exactly what the
    plain greedy loop emits. Returns ``(accept [B, k] bool, counts [B],
    n_adv [B] (accepted non-eos tokens: how far pos advances), new_logits
    [B, V] (after the last accepted token), last_tok [B])``."""
    k = props.shape[1]
    g = verify_logits.argmax(-1)
    ok = [can & (pos < limit)]
    for j in range(1, k):
        okj = ok[-1] & (props[:, j] == g[:, j - 1]) & (pos + j < limit)
        if eos_token_id is not None:
            okj = okj & (props[:, j - 1] != eos_token_id)
        ok.append(okj)
    accept = torch.stack(ok, 1)
    counts = accept.sum(1)
    adv = accept & (props != eos_token_id) if eos_token_id is not None \
        else accept
    n_adv = adv.sum(1)
    last = (counts - 1).clamp(0, k - 1)
    return (accept, counts, n_adv, _take_along(verify_logits, last),
            _take_along(props, last))


# lanes of the stochastic key rule: every draw of the sampled spec path is
# keyed by (request seed, absolute position, lane) and nothing else, so a
# row's draws do not depend on where tick boundaries fall
SPEC_LANE_DRAFT = 0      # the draft's proposal sample at a position
SPEC_LANE_ACCEPT = 1     # the acceptance-test uniform at a position
SPEC_LANE_RESAMPLE = 2   # the residual resample at a position
_SPEC_ROOT = prng.PRNGKey(0x5BEC)


def spec_sample_key(seed, position, lane):
    """The key rule of stochastic speculative sampling: ``fold_in(fold_in(
    fold_in(PRNGKey(0x5BEC), seed), position), lane)``, over tensors
    (seeds and positions broadcast together; a tensor key ``[..., 2]``
    each), row for row ``jax.vmap`` of the reference's scalar rule."""
    pos = torch.as_tensor(position)
    seed = torch.as_tensor(seed, device=pos.device)
    k = prng.fold_in_rows(prng.fold_in_rows(_SPEC_ROOT, seed), pos)
    return prng.fold_in_rows(k, lane)


def spec_draft_sample(logits, temperature, seeds, positions, top_k=0,
                      top_p=0.0, keys=None):
    """One draft proposal per row from ``logits`` [B, V]: returns ``(tok
    [B], q [B, V] f32)``, the proposal and the post-filter proposal
    distribution the acceptance ratio divides by, drawn with
    ``spec_sample_key(seeds, positions, SPEC_LANE_DRAFT)`` (``keys``: those
    keys, when the caller derived them already). Greedy rows
    (temperature <= 0) get a one-hot q, so their draw is the argmax."""
    q = filtered_probs(logits, temperature, top_k, top_p)
    if keys is None:
        keys = spec_sample_key(seeds, positions, SPEC_LANE_DRAFT)
    return prng.categorical_rows(keys, torch.log(q)), q


def stochastic_acceptance(props, q_probs, verify_logits, base_logits,
                          temperature, seeds, pos, can, limit, pend_valid,
                          last_tok, top_k=0, top_p=0.0, eos_token_id=None):
    """Stochastic speculative acceptance (Leviathan et al., ICML 2023),
    per row. props: [B, k] the verified window (row 0 is either last
    tick's pending residual resample, ``pend_valid``, already accepted,
    or a fresh draft proposal); q_probs: [B, k, V] the draft's post-filter
    distributions (:func:`spec_draft_sample`); verify_logits: [B, k, V];
    base_logits: [B, V] the target's stored distribution at the window's
    first position; temperature and seeds: [B].

    Index j is accepted iff every earlier index was, ``u_j < p_j(x_j) /
    q_j(x_j)`` (u_j keyed by (seed, pos + j, ACCEPT)), ``pos + j < limit``
    and no earlier accepted token was eos. At the first ratio rejection a
    correction token is drawn from the normalized residual ``max(0, p -
    q)`` (keyed by (seed, pos + j, RESAMPLE)); it is not emitted this tick
    but returned pending, for the next tick's window row 0. p, q and the
    ratio are f32, both filtered through the one :func:`filtered_probs`.

    Returns ``(accept [B, k], counts [B], n_adv [B], new_logits [B, V],
    last_tok [B], pend_tok [B], pend_valid [B])``: ``pend_valid`` marks the
    rows that drew a resample this tick."""
    B, k = props.shape
    dev = props.device
    tb = torch.as_tensor(temperature, dtype=torch.float32, device=dev
                         ).expand(B)[:, None]
    base_logits = base_logits.float()
    # the target's distribution at window index j: after window token j-1;
    # index 0's is the stored distribution the last tick left
    p_src = torch.cat([base_logits[:, None],
                       verify_logits.float()[:, :-1]], dim=1)
    p_probs = filtered_probs(p_src, tb, top_k, top_p)
    q_probs = q_probs.float()
    idx = props[:, :, None]
    p_tok = torch.gather(p_probs, 2, idx)[:, :, 0]
    q_tok = torch.gather(q_probs, 2, idx)[:, :, 0]
    posw = pos[:, None] + torch.arange(k, device=dev)[None, :]
    # one position key per window index serves both lanes
    pkeys = prng.fold_in_rows(prng.fold_in_rows(
        _SPEC_ROOT, torch.as_tensor(seeds, device=dev))[:, None], posw)
    u = prng.uniform_rows(prng.fold_in_rows(pkeys, SPEC_LANE_ACCEPT))
    # accept iff u < min(1, p/q): a ratio >= 1 always accepts (u < 1), p ==
    # 0 never does; greedy rows degenerate to equality
    take = u < p_tok / torch.clamp_min(q_tok, 1e-30)
    elig = [can & (pos < limit)]
    ok = [elig[0] & (pend_valid | take[:, 0])]
    for j in range(1, k):
        ej = ok[-1] & (pos + j < limit)
        if eos_token_id is not None:
            ej = ej & (props[:, j - 1] != eos_token_id)
        elig.append(ej)
        ok.append(ej & take[:, j])
    eligible = torch.stack(elig, 1)
    accept = torch.stack(ok, 1)
    counts = accept.sum(1)
    adv = accept & (props != eos_token_id) if eos_token_id is not None \
        else accept
    n_adv = adv.sum(1)
    last = (counts - 1).clamp(0, k - 1)
    moved = counts > 0
    # counts == 0 (a fresh row 0 ratio-rejected): the window advanced
    # nothing, so the stored distribution and last token stay
    new_logits = torch.where(moved[:, None], _take_along(verify_logits, last),
                             base_logits)
    new_last = torch.where(moved, _take_along(props, last), last_tok)
    # the first RATIO rejection (eligible, failed the uniform) resamples;
    # chains stopped by the limit or eos resample nothing
    jrej = counts.clamp(0, k - 1)
    rejected = (counts < k) & _take_along(eligible, jrej) \
        & ~_take_along(accept, jrej)
    p_r = _take_along(p_probs, jrej)
    q_r = _take_along(q_probs, jrej)
    res = torch.clamp_min(p_r - q_r, 0.0)
    norm = res.sum(-1, keepdim=True)
    # q >= p everywhere makes a rejection impossible; should float dust
    # land here anyway, p keeps the draw honest
    res = torch.where(norm > 0.0, res / torch.clamp_min(norm, 1e-30), p_r)
    y = prng.categorical_rows(prng.fold_in_rows(
        _take_along(pkeys, jrej), SPEC_LANE_RESAMPLE), torch.log(res))
    pend_tok = torch.where(rejected, y, torch.zeros_like(y))
    return accept, counts, n_adv, new_logits, new_last, pend_tok, rejected


@torch.no_grad()
def generate(params, cfg: GPTConfig, prompt_tokens, max_new_tokens=32,
             temperature=0.0, top_k=0, top_p=0.0, seed=0,
             prefill_mode: str | None = None, device=None):
    """Greedy / top-k / top-p generation with a KV cache. prompt_tokens:
    [B, P] ints. Returns [B, P + max_new_tokens] int64 on ``device``.
    The prompt prefills in one batched forward ("full", or "chunked"
    attention tiles; PADDLE_TPU_PREFILL_MODE sets the default), then one
    decode step per new token.

    A step (split the key, sample, decode the token, position + 1) reads
    and writes only device state: the key (a tensor key), the positions,
    the logits, the caches and the output columns. On the card the steps
    replay one captured CUDA graph (``framework.cuda_graph``, the
    counterpart of the reference's ``lax.scan``; the first step is the
    warm-up, run eagerly), so nothing is read back until the caller reads
    the result; inside ``eager_ticks()`` and on the CPU every step runs
    eagerly. A greedy step draws nothing: its key is never read, so it is
    not split either."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    mode = check_prefill_mode(
        prefill_mode or os.environ.get("PADDLE_TPU_PREFILL_MODE", "full"))
    prompt = torch.as_tensor(prompt_tokens).to(dev).long()
    B, P = prompt.shape
    if P + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq ({cfg.max_seq}) — positions past max_seq have no "
            f"positional embedding")
    kc, vc = init_kv_cache(cfg, B, pad_cache_len(P + max_new_tokens,
                                                 cfg.decode_block), dev)
    logits, kc, vc = prefill(params, cfg, prompt, kc, vc, mode=mode)
    key = torch.tensor(prng.PRNGKey(seed), dtype=torch.int64, device=dev)
    pos = torch.full((B,), P, dtype=torch.int64, device=dev)
    toks = torch.empty((B, max_new_tokens), dtype=torch.int64, device=dev)

    def draw():
        sub = None
        if temperature != 0.0:
            key_sub = prng.split(key)
            key.copy_(key_sub[0])
            sub = key_sub[1]
        tok = sample_logits(logits, sub, temperature, top_k, top_p)
        toks.index_copy_(1, pos[:1] - P, tok[:, None])
        return tok

    def step():
        new_logits, _, _ = decode_one_token(params, cfg, draw(), pos, kc, vc)
        logits.copy_(new_logits)
        pos.add_(1)
        return pos

    # the last token needs no forward
    tick = TickGraph(step, dev) if graphed(dev) else step
    for _ in range(max_new_tokens - 1):
        tick()
    draw()
    return torch.cat([prompt, toks], dim=1)


# ==========================================================================
# Training: the dense single-device branch of build_spmd_train_step
# ==========================================================================
def _block(x, p, cfg: GPTConfig):
    """One transformer block over the whole sequence, x: [B, S, D]; p: one
    layer's weights. Attention is the causal flash kernel (its backward
    kernels under autograd on the card)."""
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    q, k, v = _split_qkv(h @ p["w_qkv"] + p["b_qkv"], cfg)
    attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           None, True)
    B, S = x.shape[:2]
    attn = attn.transpose(1, 2).reshape(B, S, -1)
    x = x + attn @ p["w_o"] + p["b_o"]
    h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    return _ffn_dense(x, h, p)


def _remat(fn, *args):
    """``jax.checkpoint``: keep only the inputs, recompute the rest on the
    backward pass. Without grad there is nothing to save and it is a call.
    Nothing inside draws random numbers, so no RNG state is stashed."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _stage_fn(params, x, cfg: GPTConfig):
    """The layer stack (the reference's ``lax.scan`` over stacked blocks),
    each block recomputed on the backward pass when ``cfg.remat``."""
    for lp in layer_params(params):
        x = _remat(_block, x, lp, cfg) if cfg.remat else _block(x, lp, cfg)
    return x


def _embed(params, tokens):
    """``wte[tokens] + wpe[arange(S)]`` in the params' dtype."""
    return params["wte"][tokens] + params["wpe"][:tokens.shape[1]]


def forward(params, cfg: GPTConfig, tokens):
    """tokens [B, S] -> f32 logits [B, S, V]: embedding, the layer stack,
    final LayerNorm and the tied lm-head (``__graft_entry__.entry()``'s
    forward)."""
    tokens = torch.as_tensor(tokens, device=params["wte"].device).long()
    x = _stage_fn(params, _embed(params, tokens), cfg)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return _lm_head(x, params["wte"])


def _xent(x, wte, labels):
    """Per-token cross entropy, x: [B, S, D], labels [B, S]: f32 logits from
    operands in the params' dtype, ``log sum exp(l - m) + m - l[label]``
    with the max m detached (it only keeps exp in range)."""
    logits = _LMHead.apply(x.reshape(-1, x.shape[-1]), wte).reshape(
        *x.shape[:-1], wte.shape[0])
    m = logits.detach().amax(-1)
    z = torch.exp(logits - m[..., None]).sum(-1)
    tgt = logits.gather(-1, labels[..., None])[..., 0]
    return torch.log(z) + m - tgt


def _xent_chunked(x, wte, labels, cfg: GPTConfig):
    """:func:`_xent` over ``cfg.xent_chunks`` sequence chunks, each
    recomputed on the backward pass, so one chunk's logits exist at a
    time. A chunk count that does not divide S falls back to one chunk."""
    C = cfg.xent_chunks
    S = x.shape[1]
    if C <= 1 or S % C:
        if C > 1:
            warnings.warn(
                f"xent_chunks={C} does not divide the sequence length {S}; "
                "falling back to unchunked cross entropy (full [B,S,V] "
                "logits buffer)")
        return _xent(x, wte, labels)
    Sc = S // C
    return torch.cat([_remat(_xent, x[:, i * Sc:(i + 1) * Sc], wte,
                             labels[:, i * Sc:(i + 1) * Sc])
                      for i in range(C)], dim=1)


def local_loss(params, cfg: GPTConfig, tokens, labels):
    """Mean next-token loss of a batch, tokens/labels [B, S] int.

    At pp=1 the reference splits the batch into ``cfg.micro_batches`` only
    to vmap one forward over them, and takes the mean over every token; the
    whole batch in one forward computes the same loss, so the port runs it
    at once (accumulating bf16 gradients micro-batch by micro-batch would
    round differently from the reference)."""
    B = tokens.shape[0]
    if B % cfg.micro_batches:
        raise ValueError(f"batch {B} does not split into "
                         f"{cfg.micro_batches} micro-batches")
    x = _stage_fn(params, _embed(params, tokens), cfg)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return _xent_chunked(x, params["wte"], labels, cfg).mean()


def adamw_init(params, dtype=torch.float32, device=None) -> dict:
    """Zero AdamW state ``{"m", "v", "step"}`` for a parameter tree, the
    moments in ``dtype`` and the int32 step counter, on ``device``."""
    dev = resolve_device(device)
    zeros = lambda t: torch.zeros(t.shape, dtype=dtype, device=dev)
    leaves = tree_flatten(params)
    return {"m": tree_unflatten(params, map(zeros, leaves)),
            "v": tree_unflatten(params, map(zeros, leaves)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _adamw_update(params, grads, opt, lr, wd=0.1, b1=0.9, b2=0.95, eps=1e-8,
                  fused=False):
    """One AdamW step, decoupled decay ``p - lr (upd + wd p)``, math in f32
    with the moments stored in their own dtype. ``fused`` takes the
    one-kernel-per-leaf path when every moment is f32 (on the card it
    updates params and moments in place)."""
    step = opt["step"] + 1
    if fused and all(t.dtype == torch.float32
                     for t in tree_flatten(opt["m"])):
        new_p, new_m, new_v = fused_adamw_update(
            params, grads, opt["m"], opt["v"], opt["step"], lr, wd=wd, b1=b1,
            b2=b2, eps=eps, device=opt["step"].device)
        return new_p, {"m": new_m, "v": new_v, "step": step}
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m.float() + (1 - b1) * gf
        v2 = b2 * v.float() + (1 - b2) * gf.square()
        upd_ = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        pf = p.float()
        p2 = pf - lr * (upd_ + wd * pf)
        return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    out = [upd(*leaf) for leaf in zip(*(tree_flatten(t) for t in (
        params, grads, opt["m"], opt["v"])))]
    return (tree_unflatten(params, (o[0] for o in out)),
            {"m": tree_unflatten(params, (o[1] for o in out)),
             "v": tree_unflatten(params, (o[2] for o in out)),
             "step": step})


def _batch(tokens, dev):
    return torch.as_tensor(tokens, device=dev).long()


def build_train_step(cfg: GPTConfig, lr=3e-4, wd=0.1, device=None,
                     sentinel=False):
    """Returns ``step(params, opt, tokens, labels) -> (params, opt, loss)``,
    the single-device counterpart of ``build_spmd_train_step``: loss and
    gradients by autograd, then ``_adamw_update(..., fused=
    cfg.fused_adamw)``. ``opt`` comes from :func:`adamw_init` with
    ``cfg.opt_dtype``. Gradients are taken with respect to detached copies
    of the leaves, so the params stay plain tensors that ``generate()``
    takes as they are. With ``cfg.fused_adamw`` on the card the returned
    params and moments are the given tensors, updated in place."""
    if sentinel:
        raise NotImplementedError(
            "sentinel=True: the in-program anomaly sentinel belongs to "
            "the training-guards slice, not ported yet")
    dev = resolve_device(device)

    def step(params, opt, tokens, labels):
        check_params_device(params, dev)
        tokens, labels = _batch(tokens, dev), _batch(labels, dev)
        leaves = [t.detach().requires_grad_() for t in tree_flatten(params)]
        with torch.enable_grad():
            loss = local_loss(tree_unflatten(params, leaves), cfg, tokens,
                              labels)
            grads = torch.autograd.grad(loss, leaves)
        new_params, new_opt = _adamw_update(
            params, tree_unflatten(params, grads), opt, lr, wd,
            fused=cfg.fused_adamw)
        return new_params, new_opt, loss.detach()

    return step


def build_eval_step(cfg: GPTConfig, device=None):
    """Returns ``eval_step(params, tokens, labels) -> loss``, the forward
    of the train step without gradients (``build_spmd_eval_step``)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(params, tokens, labels):
        check_params_device(params, dev)
        return local_loss(params, cfg, _batch(tokens, dev),
                          _batch(labels, dev))

    return eval_step

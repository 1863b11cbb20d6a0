"""Length-bounded decode attention: the CUDA kernels of
``csrc/decode_attention.cu`` and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/decode_attention.py. A window of Q query
rows ``q [B, H, Q, d]`` attends a ring-buffer cache ``[B, H, S, d]``: row
j of batch row b sees keys ``<= pos[b] + j``. A cache is a bf16/f32
tensor, or the scaled-int8 pair ``(codes int8 [B, H, S, d], steps f32
[B, H, S])`` with one absmax step per position and head
(:func:`decode_attention_q8`; models/gpt.py owns the write side).

The paged forms (:func:`decode_attention_paged`,
:func:`decode_attention_paged_q8`) read the same keys through a page
table: the cache is a pool ``[P, H, ps, d]`` (steps ``[P, H, ps]``) and
``page_table [B, nb]`` maps logical page i of row b (positions ``[i*ps,
(i+1)*ps)``) to a pool page; page 0 is the scratch page that dead table
entries name. :func:`paged_view` gathers the dense ``[B, H, nb*ps, d]``
view a paged pool stands for.

Scores, softmax and accumulation are f32 and the result is f32 — callers
cast back.

Masked keys contribute exactly 0 (``exp(-1e30 - m)`` underflows to +0.0
in f32), so a row's result does not depend on how many dead blocks the
batch-wide trip count of the plain bounded loop makes it scan.

On the card every form, bf16/f32 or scaled-int8, dense or paged, splits
each row's keys across a cluster of blocks (:func:`decode_split`,
:func:`decode_split_q8`) and merges the partial softmaxes in rank order;
the int8 forms turn the loaded codes into floats in registers and apply
each key's and value's step once a key.

Each wrapper counts its launches (``fn.launches``) and, by window width
Q, in ``fn.by_q``.
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
# csrc/decode_attention.cu, split_route: the most blocks a cluster holds
DECODE_MAX_SPLIT = 8
# the SMs of an H100, and the bf16/f32 kernel's blocks one SM holds at once
# for a window of Q rows (csrc/decode_attention.cu, the launch bounds of
# split_decode_kernel: 72 registers a thread at Q = 1). A rank waits at the
# cluster barrier for its slowest sibling, so a grid past B*H*nsplit
# resident blocks runs in two waves.
DECODE_SMS = 132


def decode_blocks_per_sm(Q: int) -> int:
    return 6 if Q == 1 else 3 if Q <= 4 else 2


def decode_blocks_per_sm_q8(Q: int) -> int:
    """The int8 forms' blocks an SM for :func:`decode_split_q8`: at Q = 1
    four, which the split scan on the card (``tools/torch_kernel_ab.py
    --decode-splits``) found fastest at the engine's 8 x 16 rows over 512
    and over 2048 positions (the kernel's launch bounds hold five: 96
    registers a thread); wider windows as :func:`decode_blocks_per_sm`."""
    return 4 if Q == 1 else decode_blocks_per_sm(Q)


# a rank's chunk of keys is a multiple of DECODE_CHUNK_KEYS, and nsplit
# leaves it DECODE_MIN_CHUNK keys or more
DECODE_CHUNK_KEYS = 32
DECODE_MIN_CHUNK = 64


def split_keys(S: int, nsplit: int) -> tuple[int, int]:
    """``(nsplit, chunk)`` for about ``nsplit`` ranks over S keys: chunk
    is ``ceil(S / nsplit)`` rounded up to a multiple of
    :data:`DECODE_CHUNK_KEYS`, and the ranks are the ``ceil(S / chunk)``
    that cover S."""
    chunk = -(-S // nsplit)
    chunk = -(-chunk // DECODE_CHUNK_KEYS) * DECODE_CHUNK_KEYS
    return -(-S // chunk), chunk


def _split(B, H, S, per_sm):
    nsplit = min(DECODE_MAX_SPLIT, per_sm * DECODE_SMS // (B * H),
                 S // DECODE_MIN_CHUNK)
    return split_keys(S, max(1, nsplit))


def decode_split(B: int, H: int, S: int, Q: int) -> tuple[int, int]:
    """``(nsplit, chunk)`` of a bf16/f32 kernel launch over S logical keys
    and a window of Q rows: each (b, h) is a cluster of nsplit blocks, rank
    r taking keys ``[r * chunk, (r + 1) * chunk)``. nsplit is the most ranks
    that keep the grid ``B * H * nsplit`` resident
    (:func:`decode_blocks_per_sm` on each of :data:`DECODE_SMS`), at most
    :data:`DECODE_MAX_SPLIT` and at least 1, with :data:`DECODE_MIN_CHUNK`
    keys a rank (:func:`split_keys` then fixes the chunk): 6 ranks at the
    engine's 8 x 16 rows over 512 positions, 6 at generate()'s 4 x 16 over
    384. A function of (B, H, S, Q) alone, never of the positions, the page
    size or a device value: a dense call over a paged pool's gathered view
    (S = nb * ps) splits as the paged call does, which keeps the two
    bitwise equal."""
    return _split(B, H, S, decode_blocks_per_sm(Q))


def decode_split_q8(B: int, H: int, S: int, Q: int) -> tuple[int, int]:
    """:func:`decode_split` of the scaled-int8 forms, dense and paged alike,
    on :func:`decode_blocks_per_sm_q8`: 4 ranks of 128 keys at the engine's
    8 x 16 rows over 512 positions (a rank's keys then lie on one page of
    128), 4 of 512 over 2048, 6 of 64 at generate()'s 4 x 16 over 384."""
    return _split(B, H, S, decode_blocks_per_sm_q8(Q))


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


def paged_view(cache, page_table):
    """The dense per-row view of a paged pool, port of ``_paged_view``:
    pool leaf ``[P, H, ps(, d)]`` + table ``[B, nb]`` -> ``[B, H, nb*ps(,
    d)]``; logical position j of row b reads page ``page_table[b, j //
    ps]`` at offset ``j % ps``. A ``(codes, steps)`` pair gathers leaf by
    leaf. Dead entries read the scratch page 0, past each row's live
    length, where masking hides them as it hides a dense cache's tail."""
    if isinstance(cache, tuple):
        return tuple(paged_view(c, page_table) for c in cache)
    g = cache[page_table.long()].movedim(2, 1)   # [B, H, nb, ps(, d)]
    b, h, nb, ps = g.shape[:4]
    return g.reshape((b, h, nb * ps) + tuple(g.shape[4:]))


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


def bounded_decode_attention(q, k_cache, v_cache, pos, scale, block,
                             ptab=None):
    """Online softmax over only the live k-blocks, port of
    ``_xla_bounded_decode_attention``: ``ceil((max(pos) + Q) / block)``
    blocks of ``block`` keys (``S % block == 0``), scores multiplied by
    ``scale``; a scaled-int8 cache is dequantized one block at a time
    (the reference's ``_block_f32``). The score products run one window
    row at a time so a Q-wide window matches Q single-row calls.

    ``ptab`` ([B, nb] page table) reads a paged pool ``[P, H, block, d]``
    instead (block = page size): loop step i fetches logical page i of
    every row through the table; every op after the fetch is the dense
    loop's, so the result equals the dense loop over :func:`paged_view`
    exactly."""
    kd, kst = _kv_parts(k_cache)
    vd, vst = _kv_parts(v_cache)
    _, H, S, d = kd.shape
    B, Q = q.shape[0], q.shape[2]
    if ptab is not None:
        ptab = ptab.long()
        S = ptab.shape[1] * block
    qf = q.float()
    n_live = (int(pos.max()) + (Q - 1) + block) // block
    m = torch.full((B, H, Q, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Q, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Q, d), dtype=torch.float32, device=q.device)
    for i in range(min(n_live, S // block)):
        start = i * block
        # the rows' i-th pages, or the contiguous i-th block
        win = ptab[:, i] if ptab is not None else (
            slice(None), slice(None), slice(start, start + block))
        kb = _dequant(kd[win], None if kst is None else kst[win])
        vb = _dequant(vd[win], None if vst is None else vst[win])
        idx = start + torch.arange(block, device=q.device)
        rows = []
        for j in range(Q):
            s = torch.matmul(qf[:, :, j:j + 1], kb.transpose(-1, -2)) * scale
            live = idx[None, None, None, :] <= (pos + j)[:, None, None, None]
            rows.append(torch.where(live, s, torch.full_like(s, NEG_INF)))
        m, l, acc = online_softmax_update(m, l, acc, torch.cat(rows, dim=2),
                                          vb)
    return acc / torch.where(l == 0.0, torch.ones_like(l), l)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of the library's C entries before scale and stream: q
# (pointer, bf16 flag, three strides), the caches (the int8 forms: codes,
# then steps; the paged forms: then the table), pos (pointer, int64 flag,
# stride), out, the sizes, the bf16/f32 forms' dtype flag and the split
_Q_ARGS = [_P, _I, _L, _L, _L]
_POS_OUT = [_I, _L, _P]
_ARGTYPES = {
    "decode_attention": _Q_ARGS + [_P] * 3 + _POS_OUT + [_I] * 8,
    "decode_attention_q8": _Q_ARGS + [_P] * 5 + _POS_OUT + [_I] * 7,
    "decode_attention_paged": _Q_ARGS + [_P] * 4 + _POS_OUT + [_I] * 10,
    "decode_attention_paged_q8": _Q_ARGS + [_P] * 6 + _POS_OUT + [_I] * 9,
}


def _lib(name="decode_attention"):
    """The C entry ``name`` (a key of ``_ARGTYPES``) of the library, with
    its argument types."""
    fn = getattr(_build.load("decode_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name] + [ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return fn


def _check_common(q, k_data, v_data, paged):
    """Shapes the kernels take: q [B, H, Q, d] with Q in 1..MAX_Q and d in
    _HEAD_DIMS against caches [B, H, S, d], or pools [P, H, ps, d]."""
    # a pool's leading dim is its page count, not the batch
    same_rows = paged or q.shape[0] == k_data.shape[0]
    if q.dim() != 4 or k_data.dim() != 4 or k_data.shape != v_data.shape \
            or not same_rows or q.shape[1] != k_data.shape[1] \
            or q.shape[3] != k_data.shape[3]:
        want = "pools [P,H,ps,d]" if paged else "caches [B,H,S,d]"
        raise ValueError(f"decode_attention wants q [B,H,Q,d], {want}; got "
                         f"{tuple(q.shape)}, {tuple(k_data.shape)}, "
                         f"{tuple(v_data.shape)}")
    if not 1 <= q.shape[2] <= MAX_Q:
        raise ValueError(f"decode_attention kernel takes 1..{MAX_Q} query "
                         f"rows, got {q.shape[2]}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"decode_attention kernel head dim must be one of "
                         f"{_HEAD_DIMS}, got {q.shape[3]}")


def _check_inputs(q, k_cache, v_cache, pos, paged=False):
    _check_common(q, k_cache, v_cache, paged)
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in _DTYPES:
        raise ValueError(f"decode_attention kernel takes a bf16 or f32 "
                         f"cache, got {k_cache.dtype}/{v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == pos.device):
        raise ValueError("q, caches and pos must lie on one device")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention kernel needs contiguous caches")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention kernel loads 16 bytes at a time: "
                         "the caches must start 16-byte aligned")


def _check_q8_inputs(q, k_cache, v_cache, pos, paged=False):
    if not (isinstance(k_cache, tuple) and isinstance(v_cache, tuple)
            and len(k_cache) == len(v_cache) == 2):
        raise ValueError("decode_attention_q8 takes (codes, steps) caches")
    (kd, ks), (vd, vs) = k_cache, v_cache
    _check_common(q, kd, vd, paged)
    if kd.dtype != torch.int8 or vd.dtype != torch.int8:
        raise ValueError(f"decode_attention_q8 codes must be int8, got "
                         f"{kd.dtype}/{vd.dtype}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32 \
            or ks.shape != kd.shape[:3] or vs.shape != vd.shape[:3]:
        raise ValueError(f"decode_attention_q8 steps must be f32 "
                         f"{tuple(kd.shape[:3])}, got {tuple(ks.shape)} "
                         f"{ks.dtype}, {tuple(vs.shape)} {vs.dtype}")
    if len({t.device for t in (q, kd, vd, ks, vs, pos)}) != 1:
        raise ValueError("q, caches, steps and pos must lie on one device")
    if not all(t.is_contiguous() for t in (kd, vd, ks, vs)):
        raise ValueError("decode_attention_q8 kernel needs contiguous "
                         "codes and steps")
    if kd.data_ptr() % 16 or vd.data_ptr() % 16:
        raise ValueError("decode_attention_q8 kernel loads 16 bytes at a "
                         "time: the codes must start 16-byte aligned")


def _table(page_table, q):
    """The page table as the kernel reads it: int32, contiguous [B, nb],
    on q's device (cast here, once a call)."""
    pt = torch.as_tensor(page_table).to(torch.int32).contiguous()
    if pt.dim() != 2 or pt.shape[0] != q.shape[0]:
        raise ValueError(f"page_table must be [B={q.shape[0]}, nb], got "
                         f"{tuple(pt.shape)}")
    if pt.device != q.device:
        raise ValueError("page_table must lie on q's device")
    return pt


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


def _plain_paged(q, k_pool, v_pool, pos, ptab, scale, mode):
    """The paged plain versions, as the reference dispatches them:
    ``full`` gathers the dense view first and runs the full-buffer
    formulation unchanged; ``bounded`` walks the live pages, block =
    page size."""
    if mode == "full":
        return dense_decode_attention(q, paged_view(k_pool, ptab),
                                      paged_view(v_pool, ptab), pos, scale)
    ps = _kv_parts(k_pool)[0].shape[2]
    return bounded_decode_attention(q, k_pool, v_pool, pos, scale, ps,
                                    ptab=ptab)


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _launch(q, k_cache, v_cache, pos, out, scale, ptab=None, split=None):
    """Launch the kernel on checked operands: a bf16/f32 cache or a
    scaled-int8 ``(codes, steps)`` pair, dense or (``ptab``) paged, split as
    ``split`` = (nsplit, chunk), by default :func:`decode_split` (int8:
    :func:`decode_split_q8`) of the logical length. The kernel reads q in
    f32 or bf16 through its strides and pos in int32 or int64 through its
    stride, so neither is copied for it: a call is one launch."""
    (k, ks), (v, vs) = _kv_parts(k_cache), _kv_parts(v_cache)
    if q.dtype not in _DTYPES or q.stride(-1) != 1:
        q = q.float().contiguous()
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int32)
    B, H, Q, d = q.shape
    S = k.shape[2] if ptab is None else ptab.shape[1] * k.shape[2]
    split = split or (decode_split if ks is None else decode_split_q8)(
        B, H, S, Q)
    head = (q.data_ptr(), int(q.dtype == torch.bfloat16), *q.stride()[:3],
            k.data_ptr(), v.data_ptr())
    if ks is not None:
        head += (ks.data_ptr(), vs.data_ptr())
    tail = (pos.data_ptr(), int(pos.dtype == torch.int64), pos.stride(0),
            out.data_ptr())
    if ptab is None:
        name, sizes = "decode_attention", (B, H, k.shape[2], Q, d)
    else:
        name, head = "decode_attention_paged", head + (ptab.data_ptr(),)
        sizes = (B, H, k.shape[0], k.shape[2], ptab.shape[1], Q, d)
    if ks is None:
        sizes += (_DTYPES[k.dtype],)
    else:
        name += "_q8"
    err = _lib(name)(*head, *tail, *sizes, *split, float(scale), _stream(q))
    _build.check(err, name)


def decode_attention(q, k_cache, v_cache, pos, scale=None, block=128,
                     page_table=None):
    """q: [B, H, Q, d]; k/v_cache: [B, H, S, d], or scaled-int8
    ``(codes, steps)`` pairs (handed to :func:`decode_attention_q8`);
    pos: int or [B] int tensor, the highest live cache index of window
    row 0. Returns [B, H, Q, d] f32.

    ``page_table`` ([B, nb] int) makes the caches paged pools ``[P, H, ps,
    d]`` (pairs: steps ``[P, H, ps]``), handed to
    :func:`decode_attention_paged` / :func:`decode_attention_paged_q8`;
    the block is then the page size.

    ``PADDLE_TPU_DECODE_ATTN`` picks the plain version run on CPU
    tensors: ``bounded`` (default, the online softmax over ``block``-key
    blocks up to the longest live row) or ``full`` (every cache slot).
    CUDA tensors launch the kernel in either mode — it reads exactly the
    live keys of each row — or raise."""
    if page_table is not None:
        paged = (decode_attention_paged_q8 if isinstance(k_cache, tuple)
                 else decode_attention_paged)
        return paged(q, k_cache, v_cache, pos, page_table, scale)
    if isinstance(k_cache, tuple):
        return decode_attention_q8(q, k_cache, v_cache, pos, scale, block)
    pos, scale, mode = _prepare(q, pos, scale)
    if q.device.type == "cpu":
        return _plain(q, k_cache, v_cache, pos, scale, block, mode)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    _check_inputs(q, k_cache, v_cache, pos)
    B, H, Q, d = q.shape
    out = torch.empty((B, H, Q, d), dtype=torch.float32, device=q.device)
    _launch(q, k_cache, v_cache, pos, out, scale)
    decode_attention.launches += 1
    decode_attention.by_q[Q] += 1
    return out


def decode_attention_q8(q, k_cache, v_cache, pos, scale=None, block=128):
    """:func:`decode_attention` over the scaled-int8 cache: k/v_cache are
    ``(codes int8 [B, H, S, d], steps f32 [B, H, S])`` pairs. CPU tensors
    run the plain versions (dequantized whole for ``full``, block by block
    for ``bounded``); CUDA tensors launch the int8 kernel, split as
    :func:`decode_split_q8`, which reads each live key's and value's codes
    and step and dequantizes them in registers, or raise."""
    pos, scale, mode = _prepare(q, pos, scale)
    if q.device.type == "cpu":
        return _plain(q, k_cache, v_cache, pos, scale, block, mode)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_q8: no kernel for {q.device}")
    _check_q8_inputs(q, k_cache, v_cache, pos)
    B, H, Q, d = q.shape
    out = torch.empty((B, H, Q, d), dtype=torch.float32, device=q.device)
    _launch(q, k_cache, v_cache, pos, out, scale)
    decode_attention_q8.launches += 1
    decode_attention_q8.by_q[Q] += 1
    return out


def decode_attention_paged(q, k_pool, v_pool, pos, page_table, scale=None):
    """:func:`decode_attention` over a paged bf16/f32 pool: k/v_pool
    ``[P, H, ps, d]``, page_table ``[B, nb]`` (entries in [0, P); dead
    ones name the scratch page 0), pos as for the dense form (row b's
    logical length is ``nb * ps``). CPU tensors run the plain versions;
    CUDA tensors launch the paged kernel, which reads each live key
    through its row's table, or raise."""
    pos, scale, mode = _prepare(q, pos, scale)
    if q.device.type == "cpu":
        return _plain_paged(q, k_pool, v_pool, pos, page_table, scale, mode)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_paged: no kernel for {q.device}")
    _check_inputs(q, k_pool, v_pool, pos, paged=True)
    pt = _table(page_table, q)
    B, H, Q, d = q.shape
    out = torch.empty((B, H, Q, d), dtype=torch.float32, device=q.device)
    _launch(q, k_pool, v_pool, pos, out, scale, ptab=pt)
    decode_attention_paged.launches += 1
    decode_attention_paged.by_q[Q] += 1
    return out


def decode_attention_paged_q8(q, k_pool, v_pool, pos, page_table,
                              scale=None):
    """:func:`decode_attention_paged` over a scaled-int8 pool: k/v_pool
    are ``(codes int8 [P, H, ps, d], steps f32 [P, H, ps])`` pairs. CUDA
    tensors launch the paged int8 kernel or raise."""
    pos, scale, mode = _prepare(q, pos, scale)
    if q.device.type == "cpu":
        return _plain_paged(q, k_pool, v_pool, pos, page_table, scale, mode)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_paged_q8: no kernel for "
                         f"{q.device}")
    _check_q8_inputs(q, k_pool, v_pool, pos, paged=True)
    pt = _table(page_table, q)
    B, H, Q, d = q.shape
    out = torch.empty((B, H, Q, d), dtype=torch.float32, device=q.device)
    _launch(q, k_pool, v_pool, pos, out, scale, ptab=pt)
    decode_attention_paged_q8.launches += 1
    decode_attention_paged_q8.by_q[Q] += 1
    return out


decode_attention.launches = 0
decode_attention.by_q = dict.fromkeys(range(1, MAX_Q + 1), 0)
decode_attention_q8.launches = 0
decode_attention_q8.by_q = dict.fromkeys(range(1, MAX_Q + 1), 0)
decode_attention_paged.launches = 0
decode_attention_paged.by_q = dict.fromkeys(range(1, MAX_Q + 1), 0)
decode_attention_paged_q8.launches = 0
decode_attention_paged_q8.by_q = dict.fromkeys(range(1, MAX_Q + 1), 0)

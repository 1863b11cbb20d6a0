"""The index math and arithmetic of two of the port's kernels, replayed on
the CPU and held against the JAX reference: quant_matmul's decode form
(``qmm_gemv_kernel``: a cluster of blocks splitting K, its partial sums
meeting in a fixed order) and the fused bias-dropout-residual LayerNorm's
routes (``warp``: one warp a row with an integer keep threshold; ``block``:
one block a row). The kernels themselves run on the card only
(chip_smoke.py holds them against their plain versions)."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

jqm = importlib.import_module("paddle_tpu.ops.pallas.quant_matmul")
jfr = importlib.import_module("paddle_tpu.ops.pallas.fused_residual_ln")
from paddle_tpu_torch.ops.kernels import fused_residual_ln as tfr
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm
from paddle_tpu_torch.quantization.gpt_quant import pack_int4

torch.set_num_threads(1)

H100_SMS = 132
WARPS = 16     # csrc/quant_matmul.cu gemv_route: warps of a block
WARP_COLS = 32   # columns a warp owns (two m16n8k16 tiles)
KQ = 4         # warps that split a stage's k steps, for each 32 columns
# chip_smoke.py's QMM_TOL: only the summation order differs, relative to
# max|out|
QMM_TOL = 1e-4


# ------------------------------------------ the kernel's byte arithmetic
def byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)`` on two 4-item lists (bytes or tags): item
    i of the result is item (sel >> 4i) & 7 of a + b."""
    src = list(a) + list(b)
    return [src[(sel >> (4 * i)) & 7] for i in range(4)]


def bf16_bits_to_f32(h):
    return (np.asarray(h, np.uint32) << 16).view(np.float32)


def sub_bf16x2(a, b):
    """``sub.rn.bf16x2`` on uint32 words, where the difference is exact
    (asserted): each half as f32, subtracted, back to bf16 bits."""
    out = 0
    for half in (0, 1):
        x = bf16_bits_to_f32((a >> (16 * half)) & 0xFFFF)
        y = bf16_bits_to_f32((b >> (16 * half)) & 0xFFFF)
        d = np.float32(x - y)
        bits = int(np.float32(d).view(np.uint32))
        assert bits & 0xFFFF == 0, "not exact in bf16"
        out |= (bits >> 16) << (16 * half)
    return out


def word(bs):
    return sum(int(v) << (8 * i) for i, v in enumerate(bs))


def unword(w):
    return [(w >> (8 * i)) & 0xFF for i in range(4)]


def s8x2_bf16(t, j):
    """csrc/quant_matmul.cu s8x2_bf16: bytes 2j, 2j + 1 of word t as the
    bf16x2 of their int8 values."""
    h = word(byte_perm(unword(t), [0x43] * 4, 0x4342 if j else 0x4140))
    return sub_bf16x2(h & 0xFF7FFF7F, (h & 0x00800080) | 0x43004300)


def s4x2_bf16(v, s, j):
    """csrc/quant_matmul.cu s4x2_bf16: the nibbles of byte j of v (low,
    high) as bf16x2."""
    h = word(byte_perm(unword(v), unword(s), 0x0400 | ((4 + j) << 8) | j))
    return sub_bf16x2((h & 0x000F000F) ^ 0x43084308, 0x43084308)


def _halves(wd):
    return bf16_bits_to_f32([wd & 0xFFFF, wd >> 16])


def test_code_conversion_to_bf16_is_exact_for_every_byte():
    every = np.arange(256, dtype=np.uint32)
    for lo in every[::1]:
        hi = (lo * 37 + 11) % 256          # every byte as lo, varied hi
        t = int(lo | (hi << 8) | (hi << 16) | (lo << 24))
        got = np.concatenate([_halves(s8x2_bf16(t, 0)),
                              _halves(s8x2_bf16(t, 1))])
        want = np.array([lo, hi, hi, lo], np.uint8).view(np.int8)
        np.testing.assert_array_equal(got, want.astype(np.float32))
        for j in range(4):
            v = int(lo | (hi << 8) | (lo << 16) | (hi << 24))
            byte = unword(v)[j]
            got4 = _halves(s4x2_bf16(v, v >> 4, j))
            want4 = [((byte & 0xF) ^ 8) - 8, ((byte >> 4) ^ 8) - 8]
            np.testing.assert_array_equal(got4, np.float32(want4))


# --------------------------------------- the warp's k step, by byte tags
def swizzle(bits, r):
    return 2 * ((r >> (2 if bits == 8 else 1)) & 3)


def _ring_word(r, chunk, within):
    """The stage-relative (row, column) of the 4 bytes a lane loads from
    ring row r, 16-byte chunk ``chunk``, byte ``within``. The copy stores
    chunk c of row r at c ^ swizzle(r) and the load reads chunk
    ``chunk ^ swizzle(r)`` of the same row, so the swizzle cancels;
    test_ring_swizzle_spreads_a_warps_loads_over_all_banks checks where
    the loads land."""
    return [(r, 16 * chunk + within + b) for b in range(4)]


def warp_kstep_map(bits, s, cb):
    """Replay of mma_kstep for one warp: per lane, the tagged bytes it
    loads, the byte permutes, and the mma's fragment layout (PTX ISA,
    m16n8k16 .bf16: A reg0 (row gid, k 2tig..+1), reg1 (gid + 8, same k),
    reg2 (gid, k 2tig + 8..+9), reg3 (gid + 8, k 2tig + 8..); B reg0 (k
    2tig..+1, n gid), reg1 (k 2tig + 8..+9); D (row gid, n 2tig..+1),
    (gid + 8, ...)). Returns, for tiles 0 and 1, A[16][16] of (stage row,
    column, nibble) source tags, Bk[16][8] of the stage-relative K row of
    x each B element reads, and Dcol[16] the column each D row is written
    to (the kernel's red mapping)."""
    A = [[[None] * 16 for _ in range(16)] for _ in range(2)]
    Bk = [[None] * 8 for _ in range(16)]
    Dcol = [[None] * 16 for _ in range(2)]
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        chunk, within = cb // 16 + gid // 4, 4 * (gid % 4)
        if bits == 8:
            u = [_ring_word(16 * s + 4 * tig + i, chunk, within)
                 for i in range(4)]
            tag = lambda b: b + (None,)
            t01 = [byte_perm(u[0], u[1], 0x5140), byte_perm(u[0], u[1], 0x7362)]
            t23 = [byte_perm(u[2], u[3], 0x5140), byte_perm(u[2], u[3], 0x7362)]
            regs = []
            for t in range(2):
                regs.append([])
                for src, j in ((t01[t], 0), (t01[t], 1), (t23[t], 0),
                               (t23[t], 1)):
                    h = byte_perm(src, ["c"] * 4, 0x4342 if j else 0x4140)
                    assert h[1] == h[3] == "c"
                    regs[t].append((tag(h[0]), tag(h[2])))
        else:
            v = [_ring_word(8 * s + 2 * tig + i, chunk, within)
                 for i in range(2)]
            sh = [[b + ("hi",) for b in vi] for vi in v]
            vl = [[b + ("lo",) for b in vi] for vi in v]
            regs = []
            for t in range(2):
                regs.append([])
                for i, j in ((0, 2 * t), (0, 2 * t + 1), (1, 2 * t),
                             (1, 2 * t + 1)):
                    h = byte_perm(vl[i], sh[i], 0x0400 | ((4 + j) << 8) | j)
                    regs[t].append((h[0], h[2]))
        for t in range(2):
            for reg, (row, k0) in enumerate(((gid, 2 * tig), (gid + 8, 2 * tig),
                                             (gid, 2 * tig + 8),
                                             (gid + 8, 2 * tig + 8))):
                A[t][row][k0], A[t][row][k0 + 1] = regs[t][reg]
        # B: x[gid][4 tig .. + 3] (the kernel's 8-byte load)
        xk = [4 * tig + e for e in range(4)]
        Bk[2 * tig][gid], Bk[2 * tig + 1][gid] = xk[0], xk[1]
        Bk[2 * tig + 8][gid], Bk[2 * tig + 9][gid] = xk[2], xk[3]
        for t in range(2):
            for i in range(4):
                row = gid + 8 * (i // 2)
                col = cb + 4 * gid + 2 * t + i // 2   # the kernel's red map
                Dcol[t][row] = col if Dcol[t][row] is None else Dcol[t][row]
                assert Dcol[t][row] == col
    return A, Bk, Dcol


def _k_of(bits, s, tag):
    """The stage-relative K row of a code tag (int4: packed row 2r + nibble)."""
    r, _, nib = tag
    return r if bits == 8 else 2 * r + (nib == "hi")


@pytest.mark.parametrize("bits", [8, 4])
def test_warp_kstep_map_pairs_codes_and_x_consistently(bits):
    ksteps = 8 if bits == 8 else 16
    for cb in (0, 32, 64, 96):
        for s in range(ksteps):
            A, Bk, Dcol = warp_kstep_map(bits, s, cb)
            seen = set()
            for t in range(2):
                for row in range(16):
                    cols = {A[t][row][k][1] for k in range(16)}
                    assert cols == {Dcol[t][row]}   # a D row is one column
                    for k in range(16):
                        tag = A[t][row][k]
                        seen.add((tag[0], tag[1], tag[2]))
                        # the code's K row is the x row B reads at this k
                        assert _k_of(bits, s, tag) - 16 * s \
                            == Bk[k][0] == Bk[k][5]
            # the warp's k step covers its 16 K rows x 32 columns once
            assert len(seen) == 16 * 32
            assert {c for _, c, _ in seen} == set(range(cb, cb + 32))
            assert {_k_of(bits, s, t) for t in seen} \
                == set(range(16 * s, 16 * s + 16))


def test_ring_swizzle_spreads_a_warps_loads_over_all_banks():
    for bits in (8, 4):
        for s in range(4):
            for i in range(4 if bits == 8 else 2):
                banks = set()
                for lane in range(32):
                    gid, tig = lane // 4, lane % 4
                    r = (16 * s + 4 * tig + i if bits == 8
                         else 8 * s + 2 * tig + i)
                    chunk = (32 // 16 + gid // 4) ^ swizzle(bits, r)
                    byte = r * 128 + 16 * chunk + 4 * (gid % 4)
                    banks.add((byte // 4) % 32)
                assert len(banks) == 32


# ------------------------------------------------ the block and cluster
def _codes(packed, bits):
    """Signed codes [K, N] of raw code bytes [R, N] (int4: packed row r
    holds K row 2r in its low nibble, 2r + 1 in its high)."""
    u = packed.view(np.uint8).astype(np.int32)
    if bits == 8:
        return packed.astype(np.float64)
    lo, hi = ((u & 0xF) ^ 8) - 8, ((u >> 4) ^ 8) - 8
    return np.stack([lo, hi], 1).reshape(-1, u.shape[1]).astype(np.float64)


def gemv_model(x, packed, step, bits, sms=H100_SMS):
    """Replay of qmm_gemv_kernel's blocks and clusters through the warp k
    step map: rank q sums packed rows [q rows_per, ...) in stages of 128,
    warp (column group cg, quarter kq) the k steps kq * KSTEPS/4 + j of each
    stage. Returns the output (products summed in float64 in the kernel's
    grouping), the times each code (k, n) was summed and the times each
    output (m, n) was written."""
    M, K = x.shape
    N = packed.shape[1]
    BN, SR = tqm.GEMV_BN, tqm.GEMV_STAGE_ROWS
    split = tqm.gemv_split(M, K, N, bits, sms)
    R = K // 2 if bits == 4 else K
    per_pack = K // R
    rows_per = tqm.gemv_rows_per(K, bits, split)
    tiles = -(-N // BN)
    ksteps = SR * per_pack // 16
    codes = np.zeros((K + SR * per_pack * 2, tiles * BN))   # padded: 0
    codes[:K, :N] = _codes(packed, bits)
    xs = np.zeros((K + SR * per_pack * 2, 8))
    xs[:K, :M] = x.T
    used = np.zeros((K, tiles * BN), np.int32)
    maps = {(s, cg): warp_kstep_map(bits, s, WARP_COLS * cg)
            for s in range(ksteps) for cg in range(BN // WARP_COLS)}
    part = np.zeros((split, 8, tiles * BN))
    for rank in range(split):
        r_lo = min(R, rank * rows_per)
        rows = min(R, r_lo + rows_per) - r_lo
        red = np.zeros((KQ, 8, tiles * BN))
        for t in range(-(-rows // SR)):
            kbase = (r_lo + t * SR) * per_pack   # the stage's first K row
            kend = (r_lo + rows) * per_pack      # rows past it read 0
            for (s, cg), (A, Bk, Dcol) in maps.items():
                kq = s // (ksteps // KQ)
                for tile in range(2):
                    for row in range(16):
                        ks = np.array([kbase + _k_of(bits, s, A[tile][row][k])
                                       for k in range(16)])
                        live = ks < kend
                        cols = Dcol[tile][row] + BN * np.arange(tiles)
                        a = codes[ks][:, cols] * live[:, None]  # [16, tiles]
                        b = xs[kbase + np.array([Bk[k][0] for k in range(16)])
                               + 16 * s]                         # [16, 8]
                        red[kq][:, cols] += b.T @ a
                        np.add.at(used, (ks[live][:, None], cols[None, :]), 1)
        part[rank] = red.sum(0)
    total = part.sum(0)
    outs = 8 * BN
    per = -(-outs // split)
    out = np.zeros((M, N))
    written = np.zeros((M, N), np.int32)
    for rank in range(split):
        o = np.arange(rank * per, min(outs, (rank + 1) * per))
        m, c = o // BN, o % BN
        for t in range(tiles):
            keep = (m < M) & (t * BN + c < N)
            mm, cc = m[keep], t * BN + c[keep]
            out[mm, cc] = total[mm, cc] * step[cc]
            np.add.at(written, (mm, cc), 1)
    return out, used[:, :N], written


def _qmm_inputs(M, K, N, bits, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)) \
        .bfloat16().float().numpy()            # bf16 values
    lim = 8 if bits == 4 else 128
    q = rng.integers(-lim, lim, (K, N)).astype(np.int8)
    packed = (pack_int4(torch.from_numpy(q), axis=0).numpy() if bits == 4
              else q)
    step = (rng.random(N, np.float32) * 0.01 + 1e-3).astype(np.float32)
    return x, q, packed, step


@pytest.mark.parametrize("M,K,N,bits", [
    (8, 2048, 1024, 8),     # w_in's K and split (2), 8 of its 64 tiles
    (4, 2048, 1024, 4),
    (8, 8192, 2048, 4),     # w_out: split 4
    (4, 8192, 2048, 8),
    (3, 48, 208, 8),        # ragged K and a part tile (13 lanes' columns)
    (1, 48, 208, 4),
    (2, 1000, 400, 8),      # a rank with a short slice
    (5, 1000, 400, 4),
])
def test_gemv_replay_sums_every_code_once_and_matches_reference(M, K, N,
                                                                bits):
    x, q, packed, step = _qmm_inputs(M, K, N, bits, M * 7 + K + N + bits)
    assert tqm.quant_matmul_route(M, K, N, bits, torch.bfloat16,
                                  True) == "gemv"
    out, used, written = gemv_model(x, packed, step, bits)
    assert (used == 1).all(), "a code summed other than once"
    assert (written == 1).all(), "an output written other than once"
    ref = np.asarray(jqm.quant_matmul(jnp.asarray(x), jnp.asarray(packed),
                                      jnp.asarray(step), bits))
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel <= QMM_TOL, rel


@pytest.mark.parametrize("M,K,N,bits,want", [
    (8, 2048, 8192, 8, 2),    # 64 tiles x 2 = 128 blocks <= 132 SMs
    (4, 2048, 8192, 4, 2),
    (8, 8192, 2048, 8, 4),    # 16 tiles x 4 = 64: the largest cluster
    (8, 8192, 2048, 4, 4),
    (3, 1000, 208, 8, 4),     # 2 tiles: 16 would leave ranks under a stage
    (3, 48, 208, 8, 1),       # 48 rows: one rank
    (8, 16384, 2048, 8, 4),   # a 4096-row x slice at the largest cluster
    (1, 8192, 128, 8, 4),     # 1 tile: the largest cluster
])
def test_gemv_split(M, K, N, bits, want):
    split = tqm.gemv_split(M, K, N, bits, H100_SMS)
    assert split == want
    assert tqm.gemv_slice_k(K, bits, split) <= tqm.GEMV_MAX_SLICE_K
    rows_per = tqm.gemv_rows_per(K, bits, split)
    assert rows_per % tqm.GEMV_STAGE_ROWS == 0
    assert rows_per * split >= (K // 2 if bits == 4 else K)


def test_gemv_split_fills_the_card_at_one_block_an_sm_for_both_ffn():
    for K, N in ((2048, 8192), (8192, 2048)):
        for bits in (8, 4):
            split = tqm.gemv_split(8, K, N, bits, H100_SMS)
            blocks = split * -(-N // tqm.GEMV_BN)
            # every block at once, one an SM, which a doubled split would
            # pass, or the largest cluster
            assert blocks <= H100_SMS
            assert 2 * blocks > H100_SMS or split == tqm.GEMV_MAX_SPLIT


# ------------------------------------------------- the LayerNorm's routes
P_SET = [1e-6, 0.1, 0.5, 0.9, 1 - 2 ** -24]


def _ref_keep(hashes, p):
    """The reference's keep test on uint32 hashes: the f32 of the hash
    (round to nearest) over 2^32, >= p (jnp, as _hash_uniform converts)."""
    u = jnp.asarray(hashes, jnp.uint32).astype(jnp.float32) \
        / jnp.float32(2 ** 32)
    return np.asarray(u >= jnp.float32(p))


@pytest.mark.parametrize("p", P_SET)
def test_integer_keep_threshold_is_the_float_compare(p):
    t = tfr.keep_threshold(p)
    near = np.arange(max(t - 4096, 0), min(t + 4096, 2 ** 32), dtype=np.int64)
    top = np.arange(2 ** 32 - 256, 2 ** 32, dtype=np.int64)
    low = np.arange(0, 256, dtype=np.int64)
    hashes = np.concatenate([near, top, low]).astype(np.uint32)
    np.testing.assert_array_equal(hashes.astype(np.int64) >= t,
                                  _ref_keep(hashes, p))
    # t is the first kept hash
    assert _ref_keep(np.array([t], np.uint32), p)[0]
    if t > 0:
        assert not _ref_keep(np.array([t - 1], np.uint32), p)[0]


def test_integer_keep_threshold_edges():
    assert tfr.keep_threshold(0.0) == 0
    assert tfr.keep_threshold(1.0) == 2 ** 32 - 128     # u rounds to 1.0
    assert tfr.keep_threshold(1.5) == 2 ** 32           # nothing kept


def _hash_bits(seed, rows, n_cols):
    """The reference's hash before its conversion (uint32 numpy)."""
    cols = np.arange(n_cols, dtype=np.uint32)[None, :]
    r = rows.astype(np.uint32)[:, None]
    with np.errstate(over="ignore"):
        x = (r * np.uint32(0x9E3779B9)) ^ (cols * np.uint32(0x85EBCA6B))
        x = x ^ np.uint32(seed)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_integer_keep_mask_equals_reference_mask(p):
    seed, rows = 0x5EED2000, np.arange(70000, 70064)
    bits = _hash_bits(seed, rows, 2048)
    ours = bits.astype(np.int64) >= tfr.keep_threshold(p)
    ref = np.asarray(jfr._hash_uniform(jnp.uint32(seed), jnp.asarray(rows),
                                       2048) >= p)
    np.testing.assert_array_equal(ours, ref)


def _ln_columns(d, dtype):
    """The columns each thread of a row touches, by the route's map: warp
    lane l holds 16-byte chunks l, l + 32, ... (CH of them, the least power
    of two that covers the row); block thread t holds t, t + 256, ... (VPT
    of them)."""
    route = tfr.fused_residual_ln_route(d, dtype, True)
    if route == "warp":
        vec = 16 // torch.empty((), dtype=dtype).element_size()
        chunks = d // vec
        ch = next(c for c in (1, 2, 4, 8, 16) if 32 * c >= chunks)
        assert ch * vec <= tfr.WARP_ELEMS    # the lane's registers
        cols = [q * vec + j for lane in range(32) for i in range(ch)
                for q in [lane + 32 * i] if q < chunks for j in range(vec)]
    else:
        nt = tfr.BLOCK_THREADS
        vpt = next(v for v in (1, 2, 4, 8, 16, 32) if nt * v >= d)
        cols = [t + nt * k for t in range(nt) for k in range(vpt)
                if t + nt * k < d]
    return route, cols


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d,want", [(64, "warp"), (96, "warp"),
                                    (2048, "warp"), (2050, "block"),
                                    (8192, "block")])
def test_ln_lane_column_map_covers_each_column_once(d, want, dtype):
    route, cols = _ln_columns(d, dtype)
    assert route == want
    assert sorted(cols) == list(range(d))


def test_ln_route_alignment_and_width():
    bf16 = torch.bfloat16
    assert tfr.fused_residual_ln_route(2048, bf16, False) == "block"
    assert tfr.fused_residual_ln_route(2056, bf16, True) == "block"
    assert tfr.fused_residual_ln_route(2044, torch.float32, True) == "warp"
    assert tfr.fused_residual_ln_route(2046, bf16, True) == "block"
    assert tfr.WARP_MAX_D == 2048 and tfr.MAX_D == 8192
    assert tfr.ROUTES == ("block", "warp")
    assert set(tfr.fused_bias_dropout_residual_ln.routes) == set(tfr.ROUTES)


def _warp_ln_model(x, bias, res, gamma, beta, seed, p, eps, training):
    """numpy f32 replay of the warp kernel on [n, D] rows (bf16 x and
    residual as f32): the integer keep test, an IEEE division by f32(1 - p),
    lane partial sums over the lane's chunks, the shuffle tree, the
    two-pass variance."""
    n, d = x.shape
    vec = 8
    chunks = d // vec
    ch = next(c for c in (1, 2, 4, 8) if 32 * c >= chunks)
    h = x + bias
    if training and p > 0.0:
        keep = _hash_bits(seed, np.arange(n), d).astype(np.int64) \
            >= tfr.keep_threshold(p)
        h = (h * keep.astype(np.float32)) / np.float32(1.0 - p)
    h = (h + res).astype(np.float32)

    def lane_sums(v):
        out = np.zeros((n, 32), np.float32)
        for lane in range(32):
            for i in range(ch):
                q = lane + 32 * i
                if q < chunks:
                    for j in range(vec):
                        out[:, lane] += v[:, q * vec + j]
        s = out
        for o in (16, 8, 4, 2, 1):          # the xor tree, lane 0's view
            s = s + s[:, np.arange(32) ^ o]
        return s[:, 0]

    mu = (lane_sums(h) / np.float32(d)).astype(np.float32)[:, None]
    t = h - mu
    var = (lane_sums(t * t) / np.float32(d)).astype(np.float32)[:, None]
    inv = (np.float32(1.0) / np.sqrt(var + np.float32(eps))).astype(
        np.float32)
    return (t * inv * gamma + beta).astype(np.float32)


@pytest.mark.parametrize("training", [True, False])
def test_warp_ln_model_matches_reference(training):
    rng = np.random.default_rng(8)
    n, d, p, seed = 24, 2048, 0.1, 0x5EED0000
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    x = bf(rng.standard_normal((n, d), np.float32))
    res = bf(rng.standard_normal((n, d), np.float32))
    bias, beta = (rng.standard_normal(d).astype(np.float32) * 0.1
                  for _ in range(2))
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    ours = _warp_ln_model(x, bias, res, gamma, beta, seed, p, 1e-5, training)
    ref = np.asarray(jfr._jnp_path(
        jnp.asarray(x), jnp.asarray(bias), jnp.asarray(res),
        jnp.asarray(gamma), jnp.asarray(beta), jnp.uint32(seed), p, 1e-5,
        training))
    # chip_smoke.py's FLN_TOL["f32"]: the same f32 math in another
    # summation order, relative to max(|ref|, 1); a mask bit off is O(1)
    err = (np.abs(ours - ref) / np.maximum(np.abs(ref), 1.0)).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("p", [0.1, 0.5, 1 - 2 ** -24, 1.0, 1.5])
def test_dropped_factor_is_the_reference_division_bitwise(p):
    """The warp kernel multiplies a dropped element by f32 0 / (1 - p)
    instead of dividing (v * 0) by (1 - p): the same bits for every v,
    signed zeros, infinities and NaN included."""
    v = np.array([1.5, -2.25, 0.0, -0.0, 3e38, -1e-45, np.inf, -np.inf,
                  np.nan], np.float32)
    q = np.float32(1.0 - p)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = (v * np.float32(0.0)) / q
        got = v * np.float32(tfr._dropped(p))
    np.testing.assert_array_equal(got.view(np.uint32) & 0x7FFFFFFF,
                                  want.view(np.uint32) & 0x7FFFFFFF)
    same_sign = np.signbit(got) == np.signbit(want)
    assert (same_sign | np.isnan(want)).all()

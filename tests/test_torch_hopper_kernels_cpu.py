"""The arithmetic of the port's wgmma + TMA kernels on the CPU: the bf16
flash forward (64-key tiles, an online softmax in base 2, p rounded to bf16
against the running max) and quant_matmul's prefill form (codes converted
to bf16 in a 128-byte-swizzled shared-memory tile) modelled in plain
PyTorch and numpy, held against the JAX reference (Pallas kernels in
interpret mode, XLA fallbacks); the route choices; and the build's hash of
the headers a kernel source includes. The kernels themselves run on the
card only (chip_smoke.py holds them against their plain versions)."""
import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
jqm = importlib.import_module("paddle_tpu.ops.pallas.quant_matmul")
jprim = importlib.import_module("paddle_tpu.ops.pallas.primitives")
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm

torch.set_num_threads(1)

# chip_smoke.py's TOL["bf16"]: the card's bf16 flash forward against its
# plain version, absolute on O(1) outputs
FWD_TOL_BF16 = 3e-2
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _interpret(fn, *args, **kw):
    old = jprim.interpret()
    jprim.set_interpret(True)
    try:
        return fn(*args, **kw)
    finally:
        jprim.set_interpret(old)


# ------------------------------------------------------ flash forward
def _fwd_kernel_model(q, k, v, scale, causal, tile=64):
    """The bf16 wgmma forward's arithmetic: per 64-key tile, f32 scores of
    the bf16 operands in base-2 units (scale * log2(e) folded into one
    multiply), masked keys -inf, the running max m, p = 2^(s - m) against
    the running (not final) max, rounded to bf16 before p v, the f32 row
    sum l of the unrounded p, o rescaled once a tile; o / l to bf16 and
    lse = m ln2 + ln l (natural-log units of q k^T scale)."""
    B, H, Sq, d = q.shape
    Skv = k.shape[2]
    off = Skv - Sq
    qf, kf, vf = q.float(), k.float(), v.float()
    scale2 = torch.tensor(scale, dtype=torch.float32) * np.float32(LOG2E)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, d))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, tile):
        cols = torch.arange(k0, min(k0 + tile, Skv))[None, :]
        s = torch.matmul(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2)) \
            * scale2
        if causal:
            s = torch.where(rows + off >= cols, s, torch.tensor(-math.inf))
        mx = torch.maximum(m, s.amax(-1))
        base = torch.where(mx == -math.inf, torch.zeros_like(mx), mx)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.bfloat16().float(), vf[:, :, k0:k0 + tile])
        m = mx
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe[..., None]).bfloat16()
    lse = torch.where(l == 0, torch.full_like(l, -1e30),
                      m * np.float32(LN2) + torch.log(l_safe))
    return out, lse


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _masked_logits(q, k, scale, causal):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        live = torch.arange(sq)[:, None] + (skv - sq) >= \
            torch.arange(skv)[None, :]
        s = torch.where(live, s, torch.tensor(-math.inf))
    return s


@pytest.mark.parametrize("d,sq,skv,causal", [
    (16, 64, 128, True), (16, 128, 128, False), (128, 64, 192, True),
    (128, 128, 128, True), (128, 128, 64, False)])
def test_flash_fwd_kernel_model_matches_reference(d, sq, skv, causal):
    """The model of the wgmma forward's rounding points against the port's
    plain version and the reference's Pallas forward in interpret mode, to
    chip_smoke.py's bf16 tolerance, Sq < Skv included; its LSE against
    torch.logsumexp and the reference's LSE in f32, to 1e-5 relative."""
    rng = np.random.default_rng(d * 1000 + sq + skv + causal)
    q = _normal(rng, (1, 2, sq, d))
    k, v = _normal(rng, (1, 2, skv, d)), _normal(rng, (1, 2, skv, d))
    scale = 1.0 / math.sqrt(d)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out, lse = _fwd_kernel_model(tq, tk, tv, scale, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    plain = tfa.xla_attention(tq, tk, tv, scale, causal)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jout, jlse = _interpret(jfa._flash_fwd, jq, jk, jv, scale, causal, 64,
                            64, with_lse=True)
    ref = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    for other in (plain.float(), ref):
        err = (out.float() - other).abs().max().item()
        assert err <= FWD_TOL_BF16, err
    # the model is not the plain version: p's bf16 rounding differs
    assert not torch.equal(out, plain)
    want = torch.logsumexp(_masked_logits(tq, tk, scale, causal), -1)
    ref_lse = torch.from_numpy(np.array(jlse[..., 0]))
    for other in (want, ref_lse):
        rel = ((lse - other).abs() / other.abs().clamp_min(1e-30)).max()
        assert rel.item() <= 1e-5, rel.item()


def test_flash_fwd_model_diagonal_first_tile_and_ragged_edge():
    """Rows 0-63 meet their first live keys in a diagonal tile, from
    m = -inf (alpha = 2^-inf = 0, not NaN), and Sq = Skv = 130 leaves a
    ragged last tile of two keys: the model stays finite and within the
    tolerances of the plain version."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_normal(rng, (1, 1, 130, 32))).bfloat16()
    k = torch.from_numpy(_normal(rng, (1, 1, 130, 32))).bfloat16()
    v = torch.from_numpy(_normal(rng, (1, 1, 130, 32))).bfloat16()
    out, lse = _fwd_kernel_model(q, k, v, 0.2, True)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    plain, want = tfa.xla_attention(q, k, v, 0.2, True, with_lse=True)
    assert (out.float() - plain.float()).abs().max() <= FWD_TOL_BF16
    assert ((lse - want).abs() / want.abs()).max() <= 1e-5


def test_flash_fwd_routes_by_dtype():
    assert tfa.ROUTES == {torch.bfloat16: "wgmma",
                          torch.float16: "wgmma",
                          torch.float32: "cuda-core f32"}
    assert set(tfa.ROUTES) == set(tfa._DTYPES)


# ------------------------------------------- quant_matmul's conversion
def _biased_to_f32(biased, bias):
    """The kernel's exact conversion: a biased code (0..255) placed in the
    mantissa of 2^23 (one byte permute), minus 2^23 + bias (one f32 add)."""
    bits = np.uint32(0x4B000000) | biased.astype(np.uint32)
    return bits.view(np.float32) - np.float32(2.0 ** 23 + bias)


def _convert_model(raw, bits):
    """One raw code tile [rows][n] int8 -> the codes it holds as f32, in K
    order: int8 biased by 128 (xor 0x80); int4 packed row r -> K rows 2r
    (low nibble) and 2r + 1 (high nibble), each nibble biased by 8."""
    u = raw.view(np.uint8).astype(np.uint32)
    if bits == 8:
        return _biased_to_f32(u ^ 0x80, 128)
    lo, hi = (u & 0xF) ^ 8, ((u >> 4) & 0xF) ^ 8
    return _biased_to_f32(np.stack([lo, hi], 1).reshape(-1, u.shape[1]), 8)


def test_conversion_is_exact_for_every_code():
    every = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    got = _convert_model(every, 8)
    np.testing.assert_array_equal(got, every.astype(np.float32))
    # exact in bf16 as well: the B operand the wgmma reads
    assert torch.equal(torch.from_numpy(got).bfloat16().float(),
                       torch.from_numpy(got))
    # int4: every byte, i.e. every (low, high) nibble pair
    got4 = _convert_model(every, 4)
    lo = ((every.view(np.uint8) & 0xF) ^ 8).astype(np.int32) - 8
    hi = every.astype(np.int32) >> 4
    want = np.stack([lo, hi], 1).reshape(4, 128).astype(np.float32)
    np.testing.assert_array_equal(got4, want)
    assert set(np.unique(got4)) == set(range(-8, 8))


@pytest.mark.parametrize("bits", [8, 4])
def test_conversion_matches_reference_unpack_tile(bits):
    """The model against the reference kernel's own decoder
    (quant_matmul.py:_unpack_tile) on a random tile and on every byte."""
    rng = np.random.default_rng(bits)
    raw = rng.integers(-128, 128, (32, 128)).astype(np.int8)
    raw[:2] = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    ref = np.asarray(jqm._unpack_tile(jnp.asarray(raw), bits)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(_convert_model(raw, bits), ref)


def _sw128(addr):
    """TMA's 128-byte swizzle of a byte offset inside a 1024-byte-aligned
    box: the 16-byte chunk (bits 4-6) xor the row of 128 bytes mod 8
    (bits 7-9). The wgmma descriptors read this layout."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _stage_model(raw, bits):
    """The producer warpgroup's loop, unit by unit as the kernel runs it,
    for a raw tile of BN = 128 or 256 columns: unit u = pt + 128 j is 8
    columns (c8) of raw row r = u / (BN / 8); it lands in box c8 / 8 at K
    row r (int8) or rows 2r, 2r + 1 (int4), 16-byte chunk
    (c8 % 8) ^ (row % 8). Returns the BN / 64 boxes of 8 KB as bf16."""
    box_elems = 64 * 64
    rows, bn = raw.shape
    chunks = bn // 8
    stage = torch.zeros(bn // 64 * box_elems, dtype=torch.bfloat16)
    vals = torch.from_numpy(_convert_model(raw, bits)).bfloat16()
    for pt in range(128):
        for j in range(rows * chunks // 128):
            u = pt + 128 * j
            r, c8 = u // chunks, u % chunks
            for kr in ((r,) if bits == 8 else (2 * r, 2 * r + 1)):
                chunk = (c8 % 8) ^ (kr & 7)
                at = (c8 // 8) * box_elems + (kr * 128 + chunk * 16) // 2
                stage[at:at + 8] = vals[kr, 8 * c8:8 * c8 + 8]
    return stage


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("bits", [8, 4])
def test_converted_stage_is_the_tma_swizzled_layout(bits, bn):
    """Read back through the TMA swizzle definition (MN-major [64 K][64 N]
    boxes, box c holding columns 64c..64c+63), the converted stage is the
    dequantized code tile: no column permuted, no row lost."""
    rng = np.random.default_rng(10 + bits + bn)
    raw = rng.integers(-128, 128, (64 if bits == 8 else 32, bn))
    raw = raw.astype(np.int8)
    stage = _stage_model(raw, bits)
    want = np.asarray(jqm._unpack_tile(jnp.asarray(raw), bits)
                      .astype(jnp.float32))
    got = np.zeros((64, bn), np.float32)
    for kr in range(64):
        for n in range(bn):
            at = (n // 64) * 64 * 64 + _sw128(kr * 128 + (n % 64) * 2) // 2
            got[kr, n] = stage[at].item()
    np.testing.assert_array_equal(got, want)


def test_sw128_is_a_permutation_of_16_byte_chunks():
    addrs = np.arange(0, 8192, 16)
    swz = np.array([_sw128(int(a)) for a in addrs])
    assert sorted(swz) == list(addrs)
    # 8 consecutive chunks of one row (a quarter-warp's stores) hit 8
    # distinct 16-byte bank groups
    for row in range(8):
        assert len({(_sw128(row * 128 + c * 16) % 128) // 16
                    for c in range(8)}) == 8


# ------------------------------------------------ quant_matmul's route
@pytest.mark.parametrize("M,K,N,bits,dtype,aligned,want", [
    (4, 2048, 8192, 8, torch.bfloat16, True, "gemv"),
    (8, 2048, 8192, 4, torch.bfloat16, True, "gemv"),
    # the decode form: bf16 x at M <= 8 on gemv where its 16-byte code rows
    # map and the x slice fits, else skinny; f32 x always skinny
    (1, 2048, 8192, 8, torch.bfloat16, True, "gemv"),
    (8, 2048, 8192, 8, torch.bfloat16, True, "gemv"),
    (4, 8192, 2048, 4, torch.bfloat16, True, "gemv"),
    (8, 8192, 2048, 8, torch.bfloat16, True, "gemv"),
    (3, 48, 208, 4, torch.bfloat16, True, "gemv"),      # ragged K, part tile
    (1, 16384, 2048, 8, torch.bfloat16, True, "gemv"),  # 4096-row x slice
    (8, 16392, 2048, 8, torch.bfloat16, True, "skinny"),   # 4224: too many
    (8, 2048, 8192, 8, torch.float32, True, "skinny"),
    (1, 2048, 8192, 4, torch.float32, True, "skinny"),
    (3, 48, 200, 8, torch.bfloat16, True, "skinny"),    # chip_smoke's N=200
    (3, 48, 200, 4, torch.bfloat16, True, "skinny"),
    (8, 2048, 8192, 8, torch.bfloat16, False, "skinny"),   # unaligned
    (4, 2048, 8200, 4, torch.bfloat16, True, "skinny"),
    (1024, 2048, 8192, 8, torch.float32, True, "skinny"),
    (1024, 2048, 8192, 8, torch.bfloat16, True, "wgmma"),
    (1024, 2048, 8192, 4, torch.bfloat16, True, "wgmma"),
    (1024, 8192, 2048, 8, torch.bfloat16, True, "wgmma"),
    (37, 2048, 8192, 4, torch.bfloat16, True, "wgmma"),
    (9, 16, 16, 8, torch.bfloat16, True, "wgmma"),
    (37, 48, 200, 8, torch.bfloat16, True, "wmma"),     # chip_smoke's edge
    (37, 48, 200, 4, torch.bfloat16, True, "wmma"),
    (1024, 2048, 8192, 8, torch.bfloat16, False, "wmma"),
    (100, 2044, 8192, 8, torch.bfloat16, True, "wmma"),
    (100, 2048, 8200, 4, torch.bfloat16, True, "wmma"),
])
def test_quant_matmul_route(M, K, N, bits, dtype, aligned, want):
    assert tqm.quant_matmul_route(M, K, N, bits, dtype, aligned) == want


def test_quant_matmul_route_checks_bits_and_names_the_c_routes():
    with pytest.raises(ValueError, match="bits"):
        tqm.quant_matmul_route(64, 64, 64, 3, torch.bfloat16, True)
    assert tqm.ROUTES == ("skinny", "wmma", "wgmma", "gemv")
    assert set(tqm.quant_matmul.routes) == set(tqm.ROUTES)


# ---------------------------------------------------------- the build
def test_library_path_hashes_included_headers(monkeypatch, tmp_path):
    """An edited header rebuilds every source that includes it (directly or
    through another header) and no other; no nvcc needed."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (csrc / "a.cu").write_text('#include <cuda.h>\n#include "h.cuh"\n')
    (csrc / "b.cu").write_text("#include <cuda.h>\nint b;\n")
    (csrc / "h.cuh").write_text('#pragma once\n  #include "g.cuh"\n')
    (csrc / "g.cuh").write_text("#pragma once\nint g;\n")
    assert _build.headers("a") == ["h.cuh", "g.cuh"]
    assert _build.headers("b") == []
    a0, b0 = _build.library_path("a"), _build.library_path("b")
    assert a0.parent == tmp_path / "build" and a0.name.startswith("a-")
    (csrc / "g.cuh").write_text("#pragma once\nint g2;\n")
    a1 = _build.library_path("a")
    assert a1 != a0 and _build.library_path("b") == b0
    (csrc / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n// x\n')
    assert _build.library_path("a") not in (a0, a1)
    assert _build.sources() == ["a", "b"]


def test_wgmma_sources_share_the_hopper_header():
    for name in ("decode_attention", "flash_attention_bwd",
                 "flash_attention_fwd", "quant_matmul"):
        assert _build.headers(name) == ["hopper_sm90.cuh"], name
    for name in ("fused_adamw", "fused_residual_ln"):
        assert _build.headers(name) == [], name

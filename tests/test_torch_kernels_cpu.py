"""The port's kernel modules on the CPU: each wrapper's plain PyTorch
version against the JAX reference (the Pallas kernels in interpret mode
and the XLA fallbacks), the dispatch rules, and the no-fallback rule."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the package re-exports functions under the module names: import modules
jda = importlib.import_module("paddle_tpu.ops.pallas.decode_attention")
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
jprim = importlib.import_module("paddle_tpu.ops.pallas.primitives")
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import primitives as tprim
from paddle_tpu_torch.ops.kernels.decode_attention import (
    bounded_decode_attention, decode_attention, dense_decode_attention)
from paddle_tpu_torch.ops.kernels.flash_attention import (flash_attention,
                                                          xla_attention)

torch.set_num_threads(1)

F32_TOL = 1e-5
# bf16 inputs: both sides round the probabilities and the output to bf16,
# but sum in different orders, so they may differ by one bf16 ulp of O(1)
BF16_TOL = 2e-2


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _interpret(fn, *args, **kw):
    """Run a Pallas kernel in interpret mode as the reference's own tests
    do, restoring the flag afterwards."""
    old = jprim.interpret()
    jprim.set_interpret(True)
    try:
        return fn(*args, **kw)
    finally:
        jprim.set_interpret(old)


# ------------------------------------------------------------ primitives
def test_causal_mask_matches_reference():
    s = np.zeros((6, 9), np.float32)
    for q0, k0, off in ((0, 0, 0), (4, 0, 3), (0, 5, 2)):
        ref = np.asarray(jprim.causal_mask(jnp.asarray(s), q0, k0, off))
        got = tprim.causal_mask(torch.from_numpy(s), q0, k0, off).numpy()
        np.testing.assert_array_equal(got, ref)


def test_online_softmax_update_matches_reference():
    rng = np.random.default_rng(0)
    m = _normal(rng, (4, 1))
    l = np.abs(_normal(rng, (4, 1)))
    acc, sc, v = _normal(rng, (4, 8)), _normal(rng, (4, 5)), \
        _normal(rng, (5, 8))
    ref = jprim.online_softmax_update(*(jnp.asarray(a) for a in
                                        (m, l, acc, sc, v)))
    got = tprim.online_softmax_update(*(torch.from_numpy(a) for a in
                                        (m, l, acc, sc, v)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=F32_TOL,
                                   rtol=F32_TOL)


# --------------------------------------------------------- flash forward
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,skv", [(128, 128), (64, 128)])
def test_flash_plain_matches_interpret_kernel(causal, sq, skv):
    rng = np.random.default_rng(sq + skv + causal)
    q, k, v = (_normal(rng, (1, 2, s, 32)) for s in (sq, skv, skv))
    scale = 1.0 / np.sqrt(32)
    out, lse = _interpret(jfa._flash_fwd, *(jnp.asarray(a) for a in (q, k, v)),
                          scale, causal, 64, 64, with_lse=True)
    got, glse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                scale, causal, with_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=F32_TOL,
                               rtol=F32_TOL)
    # the TPU kernel replicates the LSE over 128 lanes; the port keeps one
    np.testing.assert_allclose(glse.numpy(), np.asarray(lse)[..., 0],
                               atol=F32_TOL, rtol=F32_TOL)
    xla = jfa._xla_attention(*(jnp.asarray(a) for a in (q, k, v)), scale,
                             causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("sq,skv", [(200, 200), (37, 200), (1, 9)])
def test_flash_ragged_lengths_match_xla_reference(sq, skv):
    """Any Sq <= Skv (no multiple-of-128 requirement), f32 and bf16."""
    rng = np.random.default_rng(sq)
    q, k, v = (_normal(rng, (2, 2, s, 16)) for s in (sq, skv, skv))
    ref = np.asarray(jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         None, True))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)
    ref16 = jfa._xla_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), 0.25, True)
    got16 = xla_attention(*(torch.from_numpy(a).bfloat16()
                            for a in (q, k, v)), 0.25, True)
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(ref16, np.float32), atol=BF16_TOL)


def test_flash_wrapper_runs_no_kernel_on_cpu_and_raises_elsewhere():
    q = torch.zeros((1, 1, 4, 16))
    before = flash_attention.launches
    flash_attention(q, q, q, causal=True)
    assert flash_attention.launches == before
    meta = torch.zeros((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(meta, meta, meta)


def test_flash_kernel_input_checks():
    from paddle_tpu_torch.ops.kernels.flash_attention import _check_inputs
    ok = torch.zeros((1, 2, 8, 16))
    _check_inputs(ok, ok, ok, True)
    for args, match in (
            ((ok, ok.double(), ok, False), "dtype"),
            ((torch.zeros((1, 2, 8, 24)),) * 3 + (False,), "head dim"),
            ((ok, ok.transpose(2, 3).contiguous().transpose(2, 3), ok,
              False), "contiguous"),
            ((ok, ok[:, :, :4].contiguous(), ok[:, :, :4].contiguous(),
              True), "Sq <= Skv"),
            ((ok, torch.zeros((1, 3, 8, 16)), ok, False), "wants")):
        with pytest.raises(ValueError, match=match):
            _check_inputs(*args)


# -------------------------------------------------------- decode attention
def _decode_inputs(seed, B=3, H=2, S=32, d=16, Q=1):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, H, Q, d)), _normal(rng, (B, H, S, d)),
            _normal(rng, (B, H, S, d)))


@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_decode_plain_matches_references(Q, cache):
    q, k, v = _decode_inputs(Q, Q=Q)
    pos = np.asarray([0, 13, 31 - Q + 1], np.int32)
    scale = 0.25
    jdt = jnp.float32 if cache == "f32" else jnp.bfloat16
    tdt = torch.float32 if cache == "f32" else torch.bfloat16
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    tq = torch.from_numpy(q)
    tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    tpos = torch.from_numpy(pos).long()
    dense = np.asarray(jda._dense_decode_attention(jq, jk, jv,
                                                   jnp.asarray(pos), scale))
    bounded = np.asarray(jda._xla_bounded_decode_attention(
        jq, jk, jv, jnp.asarray(pos), scale, 8))
    kernel = np.asarray(_interpret(jda._pallas_decode_attention, jq, jk, jv,
                                   jnp.asarray(pos), scale, 8))
    # the plain versions see the same bf16-rounded cache values and do f32
    # math, so f32 tolerance holds for both cache dtypes
    got_dense = dense_decode_attention(tq, tk, tv, tpos, scale).numpy()
    got_bounded = bounded_decode_attention(tq, tk, tv, tpos, scale,
                                           8).numpy()
    for got in (got_dense, got_bounded):
        for ref in (dense, bounded, kernel):
            np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)


def test_decode_dispatch_modes_and_scalar_pos(monkeypatch):
    q, k, v = _decode_inputs(7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), 9, block=8))
    for mode in ("bounded", "full"):
        monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", mode)
        got = decode_attention(tq, tk, tv, 9, block=8)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL,
                                   rtol=F32_TOL)
    # a block that does not divide S becomes one full-width block
    monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", "bounded")
    np.testing.assert_allclose(decode_attention(tq, tk, tv, 9,
                                                block=24).numpy(),
                               ref, atol=F32_TOL, rtol=F32_TOL)
    monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", "nope")
    with pytest.raises(ValueError, match="nope"):
        decode_attention(tq, tk, tv, 9)


def test_decode_garbage_past_live_length_changes_nothing():
    q, k, v = _decode_inputs(11, Q=2)
    pos = torch.tensor([4, 20, 0])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    base = decode_attention(tq, tk, tv, pos, block=8)
    kg, vg = tk.clone(), tv.clone()
    for b, p in enumerate(pos.tolist()):
        kg[b, :, p + 2:] = 1e4
        vg[b, :, p + 2:] = -1e4
    np.testing.assert_array_equal(
        decode_attention(tq, kg, vg, pos, block=8).numpy(), base.numpy())


def test_decode_wrapper_runs_no_kernel_on_cpu_and_checks_inputs():
    from paddle_tpu_torch.ops.kernels.decode_attention import _check_inputs
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(3))
    before = decode_attention.launches
    decode_attention(q, k, v, 5)
    assert decode_attention.launches == before
    meta = torch.zeros((1, 1, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(meta, meta, meta, torch.zeros(1, device="meta"))
    pos = torch.zeros(3, dtype=torch.long)
    _check_inputs(q, k, v, pos)
    for args, match in (
            ((torch.zeros((3, 2, 9, 16)), k, v, pos), "query rows"),
            ((q, k.double(), v.double(), pos), "cache"),
            ((q, k.transpose(2, 3).contiguous().transpose(2, 3), v, pos),
             "contiguous")):
        with pytest.raises(ValueError, match=match):
            _check_inputs(*args)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: a missing toolkit is an error, never the plain path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["decode_attention"])
    assert _build.sources() == ["decode_attention", "flash_attention_bwd",
                                "flash_attention_fwd", "fused_adamw",
                                "fused_residual_ln", "quant_matmul"]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(1, "decode_attention")

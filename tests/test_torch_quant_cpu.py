"""The port's quantization module and its two quantized kernels' plain
versions on the CPU, against the JAX package on the same numpy inputs:
weight and KV codes bit for bit, the int4 nibble layout, the quantized
products, the quant_matmul Pallas kernel in interpret mode and its XLA
fallback, and the scaled-int8 decode attention kernel in interpret mode
and its bounded XLA path."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels.decode_attention import (
    _check_q8_inputs, bounded_decode_attention, decode_attention,
    decode_attention_q8, dense_decode_attention)
from paddle_tpu_torch.ops.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_ref)
from paddle_tpu_torch.quantization import gpt_quant as tq

# the package re-exports functions under the module names: import modules
jq = importlib.import_module("paddle_tpu.quantization.gpt_quant")
jqm = importlib.import_module("paddle_tpu.ops.pallas.quant_matmul")
jda = importlib.import_module("paddle_tpu.ops.pallas.decode_attention")
jprim = importlib.import_module("paddle_tpu.ops.pallas.primitives")

torch.set_num_threads(1)

F32_TOL = 1e-5


def _normal(rng, shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _interpret(fn, *args, **kw):
    old = jprim.interpret()
    jprim.set_interpret(True)
    try:
        return fn(*args, **kw)
    finally:
        jprim.set_interpret(old)


def _equal(got, ref):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(got, np.asarray(ref))


def _close(got, ref, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------ the codes
def _rows_with_ties(rng):
    """Rows whose absmax is 127 (step exactly 1), so values ending in .5
    divide to exact ties that round half to even; and random rows."""
    ties = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                       [-127.0, 3.5, -3.5, 4.5, 5.5, -6.5, 0.0, 7.5]],
                      np.float32)
    return np.concatenate([ties, _normal(rng, (6, 8), 3.0),
                           np.zeros((1, 8), np.float32)])


def test_quantize_rows_bit_equal():
    rng = np.random.default_rng(0)
    for x in (_rows_with_ties(rng), _normal(rng, (2, 3, 5, 16), 0.7)):
        codes, step = tq.quantize_rows(torch.from_numpy(x))
        rc, rs = jq.quantize_rows(jnp.asarray(x))
        assert codes.dtype == torch.int8 and step.dtype == torch.float32
        _equal(codes, rc)
        _equal(step, rs)
    # bf16 activations (the card's K/V) go through f32 on both sides
    x16 = _normal(rng, (4, 16), 2.0)
    codes, step = tq.quantize_rows(torch.from_numpy(x16).bfloat16())
    rc, rs = jq.quantize_rows(jnp.asarray(x16, jnp.bfloat16))
    _equal(codes, rc)
    _equal(step, rs)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,axis", [((16, 24), -1), ((16, 24), 0),
                                        ((3, 16, 24), -1), ((3, 16, 24), 0),
                                        ((3, 16, 24), 1)])
def test_quantize_weight_bit_equal(bits, shape, axis):
    rng = np.random.default_rng(bits + len(shape) + axis)
    w = _normal(rng, shape, 0.3)
    qmax = 127.0 if bits == 8 else 7.0
    # one slab with absmax == qmax (step 1) holding exact .5 ties
    flat = w.reshape(-1)
    flat[:6] = [qmax, 0.5, 1.5, 2.5, -3.5, -0.5]
    flat[6] = -qmax
    q, step = tq.quantize_weight(torch.from_numpy(w), bits, axis)
    rq, rs = jq.quantize_weight(jnp.asarray(w), bits, axis)
    assert q.dtype == torch.int8 and step.dtype == torch.float32
    _equal(q, rq)
    _equal(step, rs)
    assert int(q.abs().max()) <= qmax


def test_pack_unpack_every_axis_and_every_byte():
    rng = np.random.default_rng(1)
    q = rng.integers(-7, 8, (6, 8, 10)).astype(np.int8)
    for axis in (0, 1, 2, -1, -2):
        if q.shape[axis % 3] % 2:
            continue
        packed = tq.pack_int4(torch.from_numpy(q), axis=axis)
        _equal(packed, jq.pack_int4(jnp.asarray(q), axis=axis))
        back = tq.unpack_int4(packed, axis=axis)
        _equal(back, q)
        _equal(back, jq.unpack_int4(jnp.asarray(packed.numpy()), axis=axis))
    # every byte value unpacks as the reference's two arithmetic shifts
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    for axis in (0, 1):
        _equal(tq.unpack_int4(torch.from_numpy(every), axis=axis),
               jq.unpack_int4(jnp.asarray(every), axis=axis))
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros((3, 4), dtype=torch.int8), axis=0)


def _tiny_tree(seed=0):
    return jax.device_get(jg.init_params(jg.gpt_tiny(), seed))


@pytest.mark.parametrize("mode,bits", [("int8", 8), ("int4", 4)])
def test_quantize_gpt_params_bit_equal_both_routes(mode, bits):
    """The reference's quantized tree carried across through numpy and the
    port's quantize_gpt_params on the carried-across fp tree are the same
    tree, leaf for leaf, dtype for dtype."""
    tree = _tiny_tree()
    jcfg = dataclasses.replace(jg.gpt_tiny(), weight_quant=mode)
    tcfg = tg.gpt_tiny(weight_quant=mode)
    ref = jax.device_get(jq.quantize_gpt_params(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, bits))
    carried = tg.params_from_numpy(ref, tcfg, device="cpu")
    ours = tq.quantize_gpt_params(
        tg.params_from_numpy(tree, tg.gpt_tiny(), device="cpu"), tcfg, bits)
    D = tcfg.hidden
    pack = 2 if bits == 4 else 1
    assert ours["wte"].shape == (tcfg.vocab_size, D // pack)
    assert ours["blocks"]["w_in"].shape == (tcfg.n_layers, D // pack, 4 * D)
    assert ours["blocks"]["w_out"].shape == (tcfg.n_layers, 4 * D // pack, D)
    flat = lambda t: {**{k: v for k, v in t.items() if k != "blocks"},
                      **{"blocks/" + k: v for k, v in t["blocks"].items()}}
    a, b, r = flat(carried), flat(ours), flat(ref)
    assert set(a) == set(b) == set(r)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        _equal(a[k], b[k])
        _equal(b[k], r[k])
    assert b["wte"].dtype == torch.int8 and b["wte_s"].dtype == torch.float32
    with pytest.raises(ValueError, match="disagree"):
        tq.quantize_gpt_params(ours, tg.gpt_tiny(weight_quant="int8"), 4)
    with pytest.raises(ValueError, match="weight_quant"):
        tg.params_from_numpy(ref, tg.gpt_tiny(), device="cpu")


# --------------------------------------------------------- the products
@pytest.mark.parametrize("bits", [8, 4])
def test_wq_einsum_dequant_rows_and_stats_match(bits):
    rng = np.random.default_rng(2 + bits)
    x = _normal(rng, (2, 3, 16))
    w_in = _normal(rng, (16, 24), 0.3)
    w_out = _normal(rng, (24, 16), 0.3)
    wte = _normal(rng, (40, 16), 0.3)
    for eq, w, axis, pack in (("bsd,de->bse", w_in, -1, -2),
                              ("bse,ed->bsd", w_out, -1, -2),
                              ("bsd,vd->bsv", wte, 0, -1)):
        xi = x if eq != "bse,ed->bsd" else _normal(rng, (2, 3, 24))
        rq, rs = jq.quantize_weight(jnp.asarray(w), bits, axis)
        if bits == 4:
            rq = jq.pack_int4(rq, axis=pack)
        ref = jq.wq_einsum(eq, jnp.asarray(xi), rq, rs, bits, pack_axis=pack)
        got = tq.wq_einsum(eq, torch.from_numpy(xi),
                           torch.from_numpy(np.array(rq)),
                           torch.from_numpy(np.array(rs)), bits,
                           pack_axis=pack)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        _close(got.numpy(), ref, 1e-6)
    with pytest.raises(ValueError, match="serving-path"):
        tq.wq_einsum("bsd,ed->bse", torch.from_numpy(x), None, None, bits)
    rq, rs = jq.quantize_weight(jnp.asarray(wte), bits, 0)
    if bits == 4:
        rq = jq.pack_int4(rq, axis=-1)
    idx = np.asarray([[3, 0, 39], [7, 7, 1]])
    ref = jq.dequant_rows(jnp.take(rq, idx, axis=0),
                          jnp.take(rs, idx, axis=0), bits)
    tqq, trs = torch.from_numpy(np.array(rq)), torch.from_numpy(np.array(rs))
    got = tq.dequant_rows(tqq[torch.from_numpy(idx)],
                          trs[torch.from_numpy(idx)], bits)
    _close(got.numpy(), ref, 1e-6)
    # byte accounting of a whole quantized tree
    mode = {8: "int8", 4: "int4"}[bits]
    jcfg = dataclasses.replace(jg.gpt_tiny(), weight_quant=mode)
    tcfg = tg.gpt_tiny(weight_quant=mode)
    ref_tree = jq.quantize_gpt_params(jg.init_params(jcfg, 0), jcfg, bits)
    ours = tg.params_from_numpy(jax.device_get(ref_tree), tcfg, device="cpu")
    assert tq.quant_param_stats(ours, tcfg) == jq.quant_param_stats(
        ref_tree, jcfg)
    assert tq.tree_bytes(ours) == jq.tree_bytes(ref_tree)
    kc = tg.init_kv_cache(tg.gpt_tiny(kv_cache_dtype="int8"), 2, 16,
                          device="cpu")
    jkc = jg.init_kv_cache(dataclasses.replace(jg.gpt_tiny(),
                                               kv_cache_dtype="int8"), 2, 16)
    assert tq.tree_bytes(kc) == jq.tree_bytes(jkc)


# ---------------------------------------------------------- quant_matmul
def _qmm_inputs(bits, M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (M, K))
    q, step = jq.quantize_weight(jnp.asarray(_normal(rng, (K, N), 0.3)), bits,
                                 axis=-1)
    if bits == 4:
        q = jq.pack_int4(q, axis=0)
    return x, np.array(q), np.array(step)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_plain_matches_interpret_kernel(bits):
    """The plain version against the Pallas kernel in interpret mode at the
    reference test's tiling (bm=8, bk=16, bn=128)."""
    x, q, step = _qmm_inputs(bits, 16, 32, 128, 2)
    ref = _interpret(jqm._pallas_quant_matmul, jnp.asarray(x),
                     jnp.asarray(q), jnp.asarray(step), bits, bm=8, bk=16,
                     bn=128)
    got = quant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                       torch.from_numpy(step), bits)
    assert got.dtype == torch.float32 and got.shape == (16, 128)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quant_matmul_plain_matches_fallback_on_ragged_shapes(bits, dtype):
    """M=3, K=48, N=200: shapes the TPU kernel could not tile; the
    reference's XLA fallback is the oracle. bf16 x: the products are exact
    in f32, so only the summation order differs."""
    x, q, step = _qmm_inputs(bits, 3, 48, 200, 3 + bits)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    ref = jqm.quant_matmul(jnp.asarray(x, jdt), jnp.asarray(q),
                           jnp.asarray(step), bits)
    got = quant_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(q),
                       torch.from_numpy(step), bits)
    _close(got.numpy(), ref)


def test_quant_matmul_wrapper_cpu_meta_and_checks():
    x, q, step = (torch.from_numpy(a) for a in _qmm_inputs(4, 3, 48, 200, 9))
    before, routes = quant_matmul.launches, dict(quant_matmul.routes)
    out = quant_matmul(x, q, step, 4)
    assert quant_matmul.launches == before
    assert quant_matmul.routes == routes
    assert torch.equal(out, quant_matmul_ref(x, q, step, 4))
    with pytest.raises(ValueError, match="no kernel"):
        quant_matmul(x.to("meta"), q.to("meta"), step.to("meta"), 4)
    for args, match in (
            ((x[:, :47].contiguous(), q, step, 4), "even"),
            ((x, q, step[:199], 4), "step has"),
            ((x, q.to(torch.int16), step, 4), "int8"),
            ((x, q, step.double(), 4), "f32"),
            ((x.double(), q, step, 4), "bf16 or f32"),
            ((x, q, step, 8), "rows"),
            ((x, q, step, 3), "bits"),
            ((x[0], q, step, 4), "wants"),
            ((x[:, ::2], q[:12], step, 4), "contiguous")):
        with pytest.raises(ValueError, match=match):
            quant_matmul(*args)


# ------------------------------------------------ scaled-int8 decode attn
def _q8_inputs(seed, B=3, H=2, S=32, d=16, Q=1):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, H, Q, d))
    kq, ks = jq.quantize_rows(jnp.asarray(_normal(rng, (B, H, S, d))))
    vq, vs = jq.quantize_rows(jnp.asarray(_normal(rng, (B, H, S, d))))
    return q, tuple(np.array(a) for a in (kq, ks)), \
        tuple(np.array(a) for a in (vq, vs))


def _t(pair):
    return tuple(torch.from_numpy(a) for a in pair)


@pytest.mark.parametrize("Q", [1, 3])
def test_q8_decode_plain_matches_references(Q):
    q, kc, vc = _q8_inputs(Q, Q=Q)
    pos = np.asarray([0, 13, 31 - Q + 1], np.int32)
    scale = 0.25
    jk = tuple(jnp.asarray(a) for a in kc)
    jv = tuple(jnp.asarray(a) for a in vc)
    kernel = np.asarray(_interpret(jda._pallas_decode_attention,
                                   jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                   scale, 8))
    bounded = np.asarray(jda._xla_bounded_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pos), scale, 8))
    dense = np.asarray(jda._dense_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pos), scale))
    tq_, tpos = torch.from_numpy(q), torch.from_numpy(pos).long()
    got_b = bounded_decode_attention(tq_, _t(kc), _t(vc), tpos, scale, 8)
    got_d = dense_decode_attention(tq_, _t(kc), _t(vc), tpos, scale)
    for got in (got_b.numpy(), got_d.numpy()):
        for ref in (kernel, bounded, dense):
            _close(got, ref)


def test_q8_decode_dispatch_and_garbage_past_live_length(monkeypatch):
    q, kc, vc = _q8_inputs(5, Q=2)
    tq_, tk, tv = torch.from_numpy(q), _t(kc), _t(vc)
    pos = torch.tensor([4, 20, 0])
    ref = np.asarray(jda.decode_attention(
        jnp.asarray(q), tuple(jnp.asarray(a) for a in kc),
        tuple(jnp.asarray(a) for a in vc), jnp.asarray(pos), block=8))
    for mode in ("bounded", "full"):
        monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", mode)
        # the generic wrapper hands pairs to the q8 wrapper
        for fn in (decode_attention, decode_attention_q8):
            _close(fn(tq_, tk, tv, pos, block=8).numpy(), ref)
    (kd, ks), (vd, vs) = (tuple(t.clone() for t in p) for p in (tk, tv))
    for b, p in enumerate(pos.tolist()):
        kd[b, :, p + 2:], vd[b, :, p + 2:] = 127, -127
        ks[b, :, p + 2:], vs[b, :, p + 2:] = 1e4, 1e4
    for mode in ("bounded", "full"):
        monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", mode)
        got = decode_attention_q8(tq_, (kd, ks), (vd, vs), pos, block=8)
        np.testing.assert_array_equal(
            got.numpy(), decode_attention_q8(tq_, tk, tv, pos,
                                             block=8).numpy())


def test_q8_decode_wrapper_cpu_meta_and_checks():
    q, kc, vc = _q8_inputs(7)
    tq_, tk, tv = torch.from_numpy(q), _t(kc), _t(vc)
    pos = torch.zeros(3, dtype=torch.long)
    b8, b16 = decode_attention_q8.launches, decode_attention.launches
    decode_attention(tq_, tk, tv, 5)
    decode_attention_q8(tq_, tk, tv, 5)
    assert (decode_attention_q8.launches, decode_attention.launches) == (
        b8, b16)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention_q8(meta(tq_), tuple(map(meta, tk)),
                            tuple(map(meta, tv)), meta(pos))
    _check_q8_inputs(tq_, tk, tv, pos)
    kd, ks = tk
    for args, match in (
            ((tq_, kd, tv, pos), "pairs|codes, steps"),
            ((tq_, (kd.float(), ks), tv, pos), "int8"),
            ((tq_, (kd, ks[..., :-1]), tv, pos), "steps"),
            ((tq_, (kd, ks.double()), tv, pos), "steps"),
            ((tq_, (kd.transpose(2, 3).contiguous().transpose(2, 3), ks),
              tv, pos), "contiguous"),
            ((torch.zeros((3, 2, 9, 16)), tk, tv, pos), "query rows")):
        with pytest.raises(ValueError, match=match):
            _check_q8_inputs(*args)

"""The port's training kernels on the CPU: the flash-attention backward and
fused AdamW plain versions against the JAX reference's Pallas kernels in
interpret mode and its XLA fallbacks, and the no-fallback rule of their
wrappers."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the package re-exports functions under the module names: import modules
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
jadam = importlib.import_module("paddle_tpu.ops.pallas.fused_adamw")
jprim = importlib.import_module("paddle_tpu.ops.pallas.primitives")
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import fused_adamw as tadam

torch.set_num_threads(1)

# f32 end to end; the two sides sum in other orders and block sizes
F32_TOL = 2e-5


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


def _close(got, ref, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------ flash backward
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_matches_interpret_kernels(causal):
    rng = np.random.default_rng(11 + causal)
    shape = (2, 2, 128, 32)
    q, k, v, g = (_normal(rng, shape) for _ in range(4))
    scale = 1.0 / np.sqrt(32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jout, jlse = _interpret(jfa._flash_fwd, jq, jk, jv, scale, causal, 64,
                            64, with_lse=True)
    ref = _interpret(jfa._flash_bwd, jq, jk, jv, jout, jlse, jg, scale,
                     causal, 64, 64)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = tfa.flash_attention(tq, tk, tv, scale, causal, with_lse=True)
    got_ref = tfa.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, scale,
                                          causal)
    got_wrap = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tg, scale,
                                       causal)
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, got_ref, got_wrap):
        _close(a.numpy(), r)
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


@pytest.mark.parametrize("sq,skv,causal", [(64, 64, True), (200, 200, True),
                                           (37, 200, True), (50, 70, False)])
def test_flash_autograd_matches_xla_vjp(sq, skv, causal):
    """Autograd through the port's flash_attention on the CPU (it
    differentiates xla_attention) against jax.vjp of _xla_attention, any
    Sq <= Skv; and the plain backward formula agrees with both."""
    rng = np.random.default_rng(sq * 7 + skv)
    q, g = _normal(rng, (2, 3, sq, 16)), _normal(rng, (2, 3, sq, 16))
    k, v = _normal(rng, (2, 3, skv, 16)), _normal(rng, (2, 3, skv, 16))
    scale = 0.25
    _, vjp = jax.vjp(lambda a, b, c: jfa._xla_attention(a, b, c, scale,
                                                        causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, scale, causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    with torch.no_grad():
        o, lse = tfa.flash_attention(tq, tk, tv, scale, causal,
                                     with_lse=True)
        plain = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse,
                                            torch.from_numpy(g), scale,
                                            causal)
    for r, a, b in zip(ref, got, plain):
        _close(a.numpy(), r)
        _close(b.numpy(), r)


def test_flash_bwd_bf16_plain_tracks_f32():
    """bf16: the plain backward rounds p to bf16 before p^T dO (as the
    forward rounds it before p v) and its outputs to bf16, so it is held
    to the f32 backward relative to max|grad|: 2^-7 covers two bf16
    roundings of O(max) terms."""
    rng = np.random.default_rng(5)
    q, k, v, g = (_normal(rng, (1, 2, 96, 32)) for _ in range(4))
    f32 = [torch.from_numpy(a) for a in (q, k, v, g)]
    b16 = [t.bfloat16() for t in f32]
    outs = []
    for q_, k_, v_, g_ in (f32, b16):
        o, lse = tfa.flash_attention(q_, k_, v_, 0.2, True, with_lse=True)
        outs.append(tfa.flash_attention_bwd(q_, k_, v_, o, lse, g_, 0.2,
                                            True))
    for a, b in zip(*outs):
        assert b.dtype == torch.bfloat16
        scale = a.abs().max().item()
        err = (a - b.float()).abs().max().item()
        assert err <= scale / 128, (err, scale)


# chip_smoke.py's BWD_TOL["bf16"]: the card's bf16 backward kernels against
# the plain versions, relative to max|grad|
BWD_TOL_BF16 = 2 ** -6


def _wgmma_kernel_model(q, k, v, dout, lse, di, scale, causal):
    """The bf16 wgmma kernels' arithmetic in plain PyTorch: f32 s and dp
    from the bf16 operands, p and ds rounded to bf16 before the three
    products that consume them (ds k, ds^T q, p^T dO), f32 sums, bf16
    outputs. (The plain versions keep p and ds in f32, but for p before
    p^T dO.)"""
    kf, qf, df = k.float(), q.float(), dout.float()
    p = tfa._probs(q, k, lse, scale, causal)
    dp = torch.matmul(df, v.float().transpose(-1, -2))
    ds = p * (dp - di[..., None]) * scale
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.matmul(ds16, kf)
    dk = torch.matmul(ds16.transpose(-1, -2), qf)
    dv = torch.matmul(p16.transpose(-1, -2), df)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _rel(a, r):
    """max|a - r| relative to max|r|."""
    r = r.float() if torch.is_tensor(r) else torch.from_numpy(
        np.array(r, np.float32))
    return ((a.float() - r).abs().max() / r.abs().max()).item()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_kernel_rounding_points_stay_in_tolerance(causal):
    """Why BWD_TOL["bf16"] holds for the wgmma kernels, stated on the CPU:
    their rounding points (modelled above; the kernels themselves are held
    on the card) stay within it of the plain versions, and both stay
    within it of the reference's Pallas kernels run in interpret mode."""
    rng = np.random.default_rng(21 + causal)
    shape = (1, 2, 256, 64)
    q, k, v, g = (_normal(rng, shape) for _ in range(4))
    scale = 1.0 / np.sqrt(64)
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    out, lse = tfa.flash_attention(tq, tk, tv, scale, causal, with_lse=True)
    di = tfa.softmax_grad_rowsum(out, tg)
    model = _wgmma_kernel_model(tq, tk, tv, tg, lse, di, scale, causal)
    plain = (tfa.bwd_dq_ref(tq, tk, tv, tg, lse, di, scale, causal),
             *tfa.bwd_dkv_ref(tq, tk, tv, tg, lse, di, scale, causal))
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    jout, jlse = _interpret(jfa._flash_fwd, jq, jk, jv, scale, causal, 64,
                            64, with_lse=True)
    ref = _interpret(jfa._flash_bwd, jq, jk, jv, jout, jlse, jg, scale,
                     causal, 64, 64)
    for name, m, p, r in zip(("dq", "dk", "dv"), model, plain, ref):
        assert m.dtype == p.dtype == torch.bfloat16
        assert _rel(m, p) <= BWD_TOL_BF16, (name, _rel(m, p))
        r = np.asarray(r.astype(jnp.float32))
        assert _rel(m, r) <= BWD_TOL_BF16, (name, _rel(m, r))
        assert _rel(p, r) <= BWD_TOL_BF16, (name, _rel(p, r))
    # the rounding is visible (the model is not the plain version) yet
    # well inside the tolerance
    assert 0 < max(_rel(m, p) for m, p in zip(model, plain)) \
        <= BWD_TOL_BF16 / 2


def test_flash_bwd_routes_by_dtype():
    assert tfa.ROUTES == {torch.bfloat16: "wgmma",
                          torch.float16: "wgmma",
                          torch.float32: "cuda-core f32"}
    assert set(tfa.ROUTES) == set(tfa._DTYPES)


def test_flash_bwd_masked_positions_are_exact_zero():
    """Masked pairs contribute an exact 0: keys 30.. are visible only to
    rows 30.., whose dO is zero, so any nonzero p leaking through the mask
    from rows < 30 would show up in their dk or dv."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 1, 40, 16)))
               for _ in range(3))
    g = torch.from_numpy(_normal(rng, (1, 1, 40, 16)))
    g[..., 30:, :] = 0.0
    o, lse = tfa.flash_attention(q, k, v, 0.3, True, with_lse=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, g, 0.3, True)
    assert torch.count_nonzero(dk[..., 30:, :]) == 0
    assert torch.count_nonzero(dv[..., 30:, :]) == 0
    assert torch.count_nonzero(dq[..., 30:, :]) == 0


def test_flash_bwd_input_checks():
    ok = torch.zeros((1, 2, 8, 16))
    lse = torch.zeros((1, 2, 8))
    tfa._check_bwd_inputs(ok, ok, ok, ok, lse, lse, True)
    for args, match in (
            ((ok, ok, ok, ok.bfloat16(), lse, lse, True), "dO"),
            ((ok, ok, ok, ok, lse.double(), lse, True), "lse"),
            ((ok, ok, ok, ok, lse, lse[:, :, :4], True), "di"),
            ((ok, ok.bfloat16(), ok, ok, lse, lse, True), "dtype")):
        with pytest.raises(ValueError, match=match):
            tfa._check_bwd_inputs(*args)


def test_flash_bwd_wrappers_run_no_kernel_on_cpu_and_raise_elsewhere():
    q = torch.zeros((1, 1, 4, 16))
    lse = torch.zeros((1, 1, 4))
    counters = (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    tfa.flash_attention_bwd(q, q, q, q, lse, q, None, True)
    assert [c.launches for c in counters] == before
    meta = torch.zeros((1, 1, 4, 16), device="meta")
    mlse = torch.zeros((1, 1, 4), device="meta")
    for fn, args in (
            (tfa.flash_attention_bwd, (meta, meta, meta, meta, mlse, meta)),
            (tfa.flash_attention_bwd_dq, (meta, meta, meta, meta, mlse,
                                          mlse, 0.25, True)),
            (tfa.flash_attention_bwd_dkv, (meta, meta, meta, meta, mlse,
                                           mlse, 0.25, True))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(*args)
    # on a device with no kernel, autograd is never reached either
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(meta.requires_grad_(), meta, meta, causal=True)


# ------------------------------------------------------------ fused AdamW
def _adam_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = [(130,), (8, 24), (3, 5, 7)]
    mk = lambda f: {f"p{i}": f(s) for i, s in enumerate(shapes)}
    params = mk(lambda s: _normal(rng, s))
    grads = mk(lambda s: _normal(rng, s))
    m = mk(lambda s: 0.1 * _normal(rng, s))
    v = mk(lambda s: np.abs(0.1 * _normal(rng, s)))
    return params, grads, m, v


def _to_torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(a).to(dtype) for k, a in tree.items()}


@pytest.mark.parametrize("grad_scale", [None, 0.5])
def test_fused_adamw_plain_matches_interpret_kernel(grad_scale):
    """bf16 params, f32 moments, step 3 (the reference's own case): the
    plain version against the Pallas kernel in interpret mode. The f32
    moments agree to f32 rounding; p to one bf16 rounding of the result
    (the two may round an f32 value on either side of a bf16 tie)."""
    params, grads, m, v = _adam_tree(21)
    jtree = lambda t, dt=jnp.float32: {k: jnp.asarray(a, dt)
                                       for k, a in t.items()}
    ref = _interpret(jadam.fused_adamw_update, jtree(params, jnp.bfloat16),
                     jtree(grads, jnp.bfloat16), jtree(m), jtree(v),
                     jnp.int32(3), 1e-2, wd=0.1, grad_scale=grad_scale)
    got = tadam.fused_adamw_update(
        _to_torch(params, torch.bfloat16), _to_torch(grads, torch.bfloat16),
        _to_torch(m), _to_torch(v), torch.tensor(3, dtype=torch.int32),
        1e-2, wd=0.1, grad_scale=grad_scale, device="cpu")
    for r_tree, g_tree, tol in zip(ref, got, (2 ** -8, 1e-6, 1e-6)):
        assert list(g_tree) == sorted(r_tree)
        for key in r_tree:
            if tol == 2 ** -8:
                assert g_tree[key].dtype == torch.bfloat16
            np.testing.assert_allclose(g_tree[key].float().numpy(),
                                       np.asarray(r_tree[key], np.float32),
                                       rtol=tol, atol=1e-6, err_msg=key)


def test_fused_adamw_reference_update_is_the_reference_formula():
    """The port's flat plain update against the reference's
    _reference_update on the same [7] scalars, f32 params."""
    params, grads, m, v = _adam_tree(4)
    sc = np.asarray([3e-3, 0.9, 0.95, 1e-8, 1 - 0.9 ** 2, 1 - 0.95 ** 2,
                     0.25], np.float32)
    for key in params:
        ref = jadam._reference_update(*(jnp.asarray(t[key].reshape(-1))
                                        for t in (params, grads, m, v)),
                                      jnp.asarray(sc), 0.1)
        got = tadam.reference_update(*(torch.from_numpy(t[key].reshape(-1))
                                       for t in (params, grads, m, v)),
                                     torch.from_numpy(sc), 0.1)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7)


def test_fused_adamw_scalars_match_the_reference():
    got = tadam.adamw_scalars(torch.tensor(4, dtype=torch.int32), 1e-3, 0.9,
                              0.95, 1e-8, torch.tensor(0.5), "cpu")
    t = np.float32(5.0)
    want = np.asarray([1e-3, 0.9, 0.95, 1e-8, 1 - np.float32(0.9) ** t,
                       1 - np.float32(0.95) ** t, 0.5], np.float32)
    assert got.dtype == torch.float32 and got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_fused_adamw_checks_dtypes_and_devices():
    p = {"w": torch.zeros(8)}
    m = {"w": torch.zeros(8)}
    step = torch.tensor(0, dtype=torch.int32)
    before = tadam.fused_adamw_update.launches
    tadam.fused_adamw_update(p, p, m, m, step, 1e-3, device="cpu")
    assert tadam.fused_adamw_update.launches == before
    for args, match in (
            (({"w": torch.zeros(8, dtype=torch.float64)},) * 2 + (m, m),
             "bf16 or f32"),
            ((p, {"w": torch.zeros(8).bfloat16()}, m, m), "bf16 or f32"),
            ((p, p, {"w": torch.zeros(8).bfloat16()}, m), "f32 moments"),
            ((p, p, {"w": torch.zeros(4)}, m), "shapes"),
            ((p, p, m, {}), "differ in size")):
        with pytest.raises(ValueError, match=match):
            tadam.fused_adamw_update(*args, step, 1e-3, device="cpu")
    meta = {"w": torch.zeros(8, device="meta")}
    with pytest.raises(ValueError, match="no kernel"):
        tadam.fused_adamw_update(meta, meta, meta, meta, 0, 1e-3,
                                 device="meta")


def test_tree_flatten_order_is_jax_order():
    tree = {"wte": 1, "blocks": {"w_o": 2, "b_o": 3}, "lnf_g": 4}
    assert tadam.tree_flatten(tree) == jax.tree_util.tree_leaves(tree)
    rebuilt = tadam.tree_unflatten(tree, tadam.tree_flatten(tree))
    assert rebuilt == tree

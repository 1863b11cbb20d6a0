"""The fused bias-dropout-residual LayerNorm of the port
(ops/kernels/fused_residual_ln.py, incubate/nn) against the JAX reference
(paddle_tpu/ops/pallas/fused_residual_ln.py, paddle_tpu.incubate.nn) on
the CPU: the dropout hash bitwise, the op against the jnp path and the
Pallas kernel in interpret mode, gradients against jax.grad through the
reference's custom VJP, and the layer in eval and training."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import random as jrandom
from paddle_tpu.incubate.nn import FusedBiasDropoutResidualLayerNorm as JLayer
from paddle_tpu.ops.pallas import primitives as jprim
import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
from paddle_tpu_torch.ops.kernels import fused_residual_ln as tf

jf = importlib.import_module("paddle_tpu.ops.pallas.fused_residual_ln")
TOL = 1e-5      # f32 end to end; the means sum in other orders


@pytest.fixture
def interpret():
    jprim.set_interpret(True)
    yield
    jprim.set_interpret(False)


def _inputs(n=13, d=96, seed=0):
    rng = np.random.default_rng(seed)
    x, res = (rng.standard_normal((n, d)).astype(np.float32)
              for _ in range(2))
    b, g, be = (rng.standard_normal(d).astype(np.float32) for _ in range(3))
    return x, b, res, g + 1.0, be


@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9, 0xFFFFFFFF])
def test_hash_bitwise_equal(seed):
    rows = np.array([0, 1, 5, 255, 65535, 65536, 70001, 2**20 + 3,
                     2**31 - 1, 2**32 - 1], np.int64)
    ref = np.asarray(jf._hash_uniform(jnp.uint32(seed),
                                      jnp.asarray(rows.astype(np.uint32)),
                                      257))
    got = tf.hash_uniform(seed, torch.from_numpy(rows), 257).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
def test_fused_op_matches_jnp_path_and_pallas_kernel(interpret, training, p):
    x, b, res, g, be = _inputs()
    jargs = [jnp.asarray(a) for a in (x, b, res, g, be)]
    ref = np.asarray(jf._jnp_path(*jargs, jnp.uint32(5), p, 1e-5, training))
    kern = np.asarray(jf._kernel_path(*jargs, jnp.uint32(5), p, 1e-5,
                                      training))
    got = tf.fused_bias_dropout_residual_ln(
        *map(torch.from_numpy, (x, b, res, g, be)), p=p, training=training,
        seed=5).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    if training and p > 0:
        # a single mask bit off would be an O(1) error; the public
        # reference entry draws the same mask
        pub = np.asarray(jf.fused_bias_dropout_residual_ln(
            *jargs, p=p, training=True, seed=5))
        np.testing.assert_allclose(got, pub, rtol=TOL, atol=TOL)


def test_fused_op_bf16_and_wide_rows():
    x, b, res, g, be = _inputs(n=9, d=300, seed=3)
    jx, jr = jnp.asarray(x, jnp.bfloat16), jnp.asarray(res, jnp.bfloat16)
    ref = np.asarray(jf._jnp_path(jx, jnp.asarray(b), jr, jnp.asarray(g),
                                  jnp.asarray(be), jnp.uint32(3), 0.25, 1e-5,
                                  True), np.float32)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
    tr = torch.from_numpy(np.asarray(jr, np.float32)).to(torch.bfloat16)
    got = tf.fused_bias_dropout_residual_ln(
        tx, torch.from_numpy(b), tr, torch.from_numpy(g),
        torch.from_numpy(be), p=0.25, training=True, seed=3)
    assert got.dtype == torch.bfloat16
    # the same f32 math rounded once to bf16: one bf16 step apart at most
    np.testing.assert_allclose(got.float().numpy(), ref,
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("training,p", [(False, 0.3), (True, 0.0),
                                        (True, 0.3)])
def test_gradients_match_reference_custom_vjp(training, p):
    x, b, res, g, be = _inputs(n=11, d=64, seed=4)
    gout = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)

    def jloss(*args):
        out = jf.fused_bias_dropout_residual_ln(*args, p=p, training=training,
                                                seed=77)
        return jnp.sum(out * gout)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, b, res, g, be)))
    targs = [torch.from_numpy(a).requires_grad_() for a in (x, b, res, g, be)]
    out = tf.fused_bias_dropout_residual_ln(*targs, p=p, training=training,
                                            seed=77)
    (out * torch.from_numpy(gout)).sum().backward()
    for t, r in zip(targs, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL)
    # only the inputs that ask for a gradient get one
    xr = torch.from_numpy(x).requires_grad_()
    tf.fused_bias_dropout_residual_ln(
        xr, *map(torch.from_numpy, (b, res, g, be)), p=p, training=training,
        seed=77).sum().backward()
    assert xr.grad is not None


def test_layer_matches_reference_eval_and_training():
    rng = np.random.default_rng(5)
    d = 96
    jl = JLayer(d, dropout_rate=0.3)
    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jl.state_dict().items()}
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tl = FusedBiasDropoutResidualLayerNorm(d, dropout_rate=0.3, device="cpu")
    assert sorted(dict(tl.named_parameters())) == sorted(state)
    assert all(p.dtype == torch.float32 for p in tl.parameters())
    tl.state_from_numpy(state)
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    r = rng.standard_normal((2, 7, d)).astype(np.float32)
    saved = jrandom.get_rng_state()
    try:
        for train in (False, True):
            jl.train() if train else jl.eval()
            tl.train(train)
            jrandom.seed(11)
            paddle_tpu_torch.seed(11)
            ref = [jl(paddle.to_tensor(x, stop_gradient=False),
                      paddle.to_tensor(r)).numpy() for _ in range(2)]
            got = [tl(torch.from_numpy(x), torch.from_numpy(r))
                   for _ in range(2)]
            assert got[0].shape == (2, 7, d)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.detach().numpy(), b, rtol=TOL,
                                           atol=TOL)
            # training draws a fresh mask each call; eval draws none
            assert torch.equal(got[0], got[1]) is (not train)
            assert jrandom.get_rng_state() == (11, 2 if train else 0)
    finally:
        jrandom.set_rng_state(saved)
        paddle_tpu_torch.seed(0)
    with pytest.raises(ValueError, match="keys"):
        tl.state_from_numpy({"ln_scale": np.ones(d, np.float32)})


def test_defaults_and_shape_checks():
    tl = FusedBiasDropoutResidualLayerNorm(8, device="cpu")
    assert tl.linear_bias.detach().abs().sum() == 0
    assert torch.equal(tl.ln_scale.detach(), torch.ones(8))
    assert "p=0.5" in repr(tl)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        tf.fused_bias_dropout_residual_ln(torch.zeros(2, 8), tl.linear_bias,
                                          torch.zeros(3, 8), tl.ln_scale,
                                          tl.ln_bias)
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tf.fused_bias_dropout_residual_ln(meta, meta[0], meta, meta[0],
                                          meta[0])

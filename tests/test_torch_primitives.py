"""The Kernel Primitive factories of the port
(ops/kernels/primitives.py: elementwise_kernel, reduce_kernel) on the
CPU, where they run their plain versions tile by tile, against the
reference's factories in Pallas interpret mode: the reference's own four
cases (tests/test_pallas_primitives.py), ragged sizes and empty input.
The Triton kernels themselves run on the card (chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import primitives as jprim
from paddle_tpu_torch.ops.kernels import primitives as tprim


@pytest.fixture(autouse=True)
def _interp():
    jprim.set_interpret(True)
    yield
    jprim.set_interpret(False)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape,block", [((37, 11), 128), ((407,), 64),
                                         ((3, 5, 7), 4096), ((1,), 1)])
def test_elementwise_unary_matches_reference(shape, block):
    x = np.random.default_rng(0).normal(size=shape).astype("float32")
    ref = np.asarray(jprim.elementwise_kernel(lambda v: jnp.maximum(v, 0.0),
                                              block=block)(x))
    got = tprim.elementwise_kernel(lambda v: torch.clamp_min(v, 0.0),
                                   block)(_t(x))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n,block", [(100, 64), (407, 128), (4096, 4096)])
def test_elementwise_binary_with_padding_matches_reference(n, block):
    a = np.random.default_rng(1).normal(size=n).astype("float32")
    b = np.random.default_rng(2).normal(size=n).astype("float32")
    ref = np.asarray(jprim.elementwise_kernel(lambda u, v: u * v + 1.0,
                                              block=block)(a, b))
    got = tprim.elementwise_kernel(lambda u, v: u * v + 1.0, block)(
        _t(a), _t(b))
    # XLA may fuse the multiply-add: one f32 rounding apart
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), a * b + 1, rtol=1e-5)


def test_elementwise_reads_operands_in_the_first_dtype():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 4
    b = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    plain = tprim.elementwise_kernel(lambda u, v: u + v, 4)
    out = plain(a, b)
    assert out.dtype == torch.float32
    ref = np.asarray(jprim.elementwise_kernel(lambda u, v: u + v, 4)(
        a.numpy(), b.numpy().astype(np.float32)))
    np.testing.assert_array_equal(out.numpy(), ref)
    three = tprim.elementwise_kernel(lambda u, v, w: u * v - w, 4)
    np.testing.assert_array_equal(three(a, a, a).numpy(),
                                  (a * a - a).numpy())


@pytest.mark.parametrize("n,block", [(1000, 256), (1000, 64), (5, 4096),
                                     (70000, 4096)])
def test_reduce_sum_and_max_match_reference(n, block):
    x = np.random.default_rng(3).normal(size=n).astype("float32")
    ssum = tprim.reduce_kernel(torch.sum, 0.0, block)
    smax = tprim.reduce_kernel(torch.amax, -np.inf, block)
    got_sum, got_max = ssum(_t(x)), smax(_t(x))
    assert got_sum.shape == () and got_sum.dtype == torch.float32
    ref_sum = float(jprim.reduce_kernel(jnp.sum, 0.0, block=block)(x))
    ref_max = float(jprim.reduce_kernel(jnp.max, -np.inf, block=block)(x))
    np.testing.assert_allclose(float(got_sum), ref_sum, rtol=1e-5,
                               atol=1e-5)
    assert float(got_max) == ref_max == x.max()
    np.testing.assert_allclose(float(got_sum), x.astype(np.float64).sum(),
                               rtol=1e-4)


def test_reduce_of_negative_rows_pads_with_the_identity():
    x = -np.abs(np.random.default_rng(4).normal(size=(3, 333))).astype(
        "float32")
    smax = tprim.reduce_kernel(torch.amax, -np.inf, 256)
    ref = float(jprim.reduce_kernel(jnp.max, -np.inf, block=256)(x))
    assert float(smax(_t(x))) == ref == x.max() < 0


def test_empty_input():
    e = torch.zeros((0,), dtype=torch.float32)
    out = tprim.elementwise_kernel(lambda v: v + 1, 64)(e)
    assert out.shape == (0,) and out.dtype == torch.float32
    assert tprim.elementwise_kernel(lambda v: v, 64)(
        torch.zeros((2, 0))).shape == (2, 0)
    assert float(tprim.reduce_kernel(torch.sum, 0.0, 64)(e)) == 0.0
    assert float(tprim.reduce_kernel(torch.amax, -np.inf, 64)(e)) == -np.inf
    # the reference's jnp.sum over no partials is 0 too
    assert float(jnp.sum(jnp.zeros((0,), jnp.float32))) == 0.0


def test_factory_checks():
    with pytest.raises(ValueError, match="power of two"):
        tprim.elementwise_kernel(lambda v: v, 100)
    with pytest.raises(ValueError, match="power of two"):
        tprim.reduce_kernel(torch.sum, 0.0, 0)
    run = tprim.elementwise_kernel(lambda u, v: u + v, 64)
    with pytest.raises(ValueError, match="one shape"):
        run(torch.zeros(3), torch.zeros(4))
    with pytest.raises(ValueError, match="1-4 operands"):
        run()
    # a Triton functor runs only on CUDA tensors: the CPU needs plain=
    jit_like = type("JITFunction", (), {"__module__": "triton.runtime.jit",
                                        "__call__": lambda self, v: v})()
    with pytest.raises(TypeError, match="plain="):
        tprim.elementwise_kernel(jit_like, 64)(torch.zeros(3))
    with pytest.raises(TypeError, match="plain="):
        tprim.reduce_kernel(jit_like, 0.0, 64)(torch.zeros(3))
    assert torch.equal(tprim.elementwise_kernel(
        jit_like, 64, plain=lambda v: v * 2)(torch.ones(3)),
        torch.full((3,), 2.0))
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tprim.elementwise_kernel(jit_like, 64)(meta)
    with pytest.raises(ValueError, match="no kernel"):
        tprim.reduce_kernel(jit_like, 0.0, 64)(meta)

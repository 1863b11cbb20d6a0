"""The port's threefry PRNG (paddle_tpu_torch/framework/prng.py) and
seeded streams (framework/random.py) against jax 0.9 and
paddle_tpu.framework.random on the CPU: keys, bits, uniforms and normals
bitwise equal, categorical indices equal."""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import random as jrandom
import paddle_tpu_torch
from paddle_tpu_torch.framework import prng
from paddle_tpu_torch.framework import random as trandom

M = 0xFFFFFFFF


def _key(k) -> list[int]:
    return [int(v) for v in np.asarray(k)]


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((M, M), (M, M), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0))])
def test_threefry_known_answers(key, count, want):
    assert prng.threefry2x32(key, *count) == want
    # the same block over int64 tensors, as bits() runs it on a device
    t = prng.threefry2x32(key, torch.tensor([count[0]]),
                          torch.tensor([count[1]]))
    assert (int(t[0]), int(t[1])) == want
    from jax._src import prng as jprng
    got = jprng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                              jnp.asarray(count, jnp.uint32))
    assert tuple(int(v) for v in np.asarray(got)) == want


def test_bits_of_key_zero_is_xor_of_first_block():
    assert int(prng.bits(prng.PRNGKey(0), (), "cpu")) == 0xF29A4FA7 \
        == 0x6B200159 ^ 0x99BA4EFE


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1])
def test_prng_key(seed):
    assert list(prng.PRNGKey(seed)) == _key(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_split(n):
    for seed in (0, 42):
        ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
        got = prng.split(prng.PRNGKey(seed), n)
        assert [list(k) for k in got] == ref.tolist()


def test_split_chain_and_fold_in():
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(4):        # generate()'s key, sub = split(key) chain
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        assert list(tk) == _key(jk) and list(tsub) == _key(jsub)
    for d in (0, 1, 7, 2**31, M):
        assert list(prng.fold_in(tk, d)) == _key(jax.random.fold_in(jk, d))
    with pytest.raises(OverflowError):
        prng.fold_in(tk, -1)


@pytest.mark.parametrize("shape", [(), (3,), (4, 7), (5, 1001)])
def test_bits(shape):
    for seed in (0, 9):
        ref = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                         jnp.uint32))
        got = prng.bits(prng.PRNGKey(seed), shape, "cpu")
        assert got.dtype == torch.uint32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), ref)
    # the tensor path and the host-int path of a scalar draw agree
    k = prng.PRNGKey(5)
    assert prng._bits_host(k) == int(prng.bits(k, (), "cpu"))


@pytest.mark.parametrize("minval,maxval", [
    (0.0, 1.0), (-2.0, 3.0), (0.5, 0.7), (float(np.finfo(np.float32).tiny),
                                          1.0)])
def test_uniform_bitwise(minval, maxval):
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.random.uniform(key, (64, 513), jnp.float32, minval,
                                        maxval))
    got = prng.uniform(prng.PRNGKey(42), (64, 513), minval, maxval,
                       "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("shape", [(), (3,), (5, 1001), (1 << 18,)])
def test_normal_bitwise(shape):
    for seed in (0, 7):
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                           jnp.float32))
        got = prng.normal(prng.PRNGKey(seed), shape, device="cpu").numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))


def test_normal_cast_last():
    key = prng.PRNGKey(4)
    want = prng.normal(key, (7, 9), device="cpu").to(torch.bfloat16)
    got = prng.normal(key, (7, 9), torch.bfloat16, device="cpu")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_counter_offset_draws_a_slice():
    key = prng.PRNGKey(11)
    whole = {f: f(key, (6, 1000), device="cpu")
             for f in (prng.bits, prng.uniform, prng.normal)}
    for f, w in whole.items():
        part = f(key, (3, 1000), device="cpu", offset=2000)
        assert torch.equal(part, w[2:5]), f.__name__
    # across the 2^32 boundary the counter's high word takes the carry
    got = prng.bits(key, (4,), "cpu", offset=M - 1).tolist()
    want = []
    for i in range(M - 1, M + 3):
        y0, y1 = prng.threefry2x32(key, i >> 32, i & M)
        want.append(y0 ^ y1)
    assert got == want
    with pytest.raises(ValueError, match="offset"):
        prng.bits(key, (2,), "cpu", offset=-1)


@pytest.mark.parametrize("name", ["bits", "uniform", "normal"])
def test_cpu_blocks_are_the_one_pass_draw(name, monkeypatch):
    """On the CPU a draw longer than _CPU_BLOCK runs a block at a time:
    the same bits as jax's draw, and as the one-pass draw at an offset
    whose counters cross the 2^32 boundary inside the draw."""
    f = getattr(prng, name)
    key, n = prng.PRNGKey(3), prng._CPU_BLOCK + 5
    got = f(key, (2, n), device="cpu")
    ref = np.asarray(getattr(jax.random, name)(jax.random.PRNGKey(3),
                                               (2, n)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    blocked = f(key, (n,), device="cpu", offset=M - 7)
    monkeypatch.setattr(prng, "_CPU_BLOCK", 4 * n)
    assert torch.equal(blocked, f(key, (n,), device="cpu", offset=M - 7))


def test_fma32_rounds_once():
    """float32 a*b + c rounded once (XLA's contracted multiply-add),
    against exact rational arithmetic: random triples and the case where
    the float64 sum lands on a float32 midpoint that the exact value
    passes."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (rng.standard_normal(4000) * 10.0 ** rng.integers(-8, 3, 4000)
         ).astype(np.float32)
    one = np.float32(1 + 2.0 ** -12)   # one*one = 1 + 2^-11 + 2^-24
    a, b, c = (np.append(v, w) for v, w in
               ((a, [one, one, one]), (b, [one, one, one]),
                (c, [2.0 ** -100, -(2.0 ** -100), 0.0])))
    c = c.astype(np.float32)
    got = prng._fma32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c).double()).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))      # within one step of the answer
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(x)) - exact) for x in cands]
        best = min(errs)
        ties = [x for x, e in zip(cands, errs) if e == best]
        want = ties[0] if len(ties) == 1 else next(
            x for x in ties if not int(x.view(np.uint32)) & 1)
        assert got[i].view(np.uint32) == want.view(np.uint32), i
    # the midpoint cases: above rounds up, below and exact to even
    assert got[-3] == np.nextafter(np.float32(1 + 2.0 ** -11), np.float32(2))
    assert got[-2] == got[-1] == np.float32(1 + 2.0 ** -11)


@pytest.mark.parametrize("shape,axis", [((16, 1000), -1), ((3, 50304), -1),
                                        ((7, 5, 9), 1)])
def test_categorical_indices(shape, axis):
    rng = np.random.default_rng(sum(shape))
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    logits[..., :2] = -np.inf          # filtered-out tokens never drawn
    for seed in (0, 1, 2):
        ref = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                                jnp.asarray(logits), axis))
        got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits),
                               axis)
        np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="float32"):
        prng.categorical(prng.PRNGKey(0), torch.zeros(2, 3,
                                                      dtype=torch.float64))


def test_generator_and_global_stream():
    jg, tg = jrandom.Generator(7), trandom.Generator(7)
    for _ in range(3):
        assert list(tg.next_key()) == _key(jg.next_key())
    assert tg.get_state() == jg.get_state() == (7, 3)
    assert tg.next_seed() == jg.next_seed()
    tg.set_state((11, 5))
    jg.set_state((11, 5))
    assert list(tg.next_key()) == _key(jg.next_key())
    assert tg.manual_seed(2).get_state() == (2, 0)
    assert tg.initial_seed == 2
    # the package-root seed() resets the global stream next_key reads
    state = jrandom.get_rng_state()
    try:
        jrandom.seed(123)
        assert paddle_tpu_torch.seed(123) is trandom.default_generator()
        for _ in range(2):
            assert list(trandom.next_key()) == _key(jrandom.next_key())
        assert trandom.get_rng_state() == jrandom.get_rng_state() == (123, 2)
        trandom.set_rng_state((5, 9))
        jrandom.set_rng_state((5, 9))
        assert list(trandom.next_key()) == _key(jrandom.next_key())
    finally:
        jrandom.set_rng_state(state)
        trandom.seed(0)


def test_trace_rng_scope():
    base = 17
    with jrandom.trace_rng(jax.random.PRNGKey(base)):
        with trandom.trace_rng(prng.PRNGKey(base)):
            ref = [_key(jrandom.next_key()) for _ in range(3)]
            got = [list(trandom.next_key()) for _ in range(3)]
            with jrandom.trace_rng(jax.random.PRNGKey(1)), \
                    trandom.trace_rng(prng.PRNGKey(1)):   # nested scopes
                assert list(trandom.next_key()) == _key(jrandom.next_key())
            assert list(trandom.next_key()) == _key(jrandom.next_key())
    assert got == ref
    assert not trandom._trace_scope.stack

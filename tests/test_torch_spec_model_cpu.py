"""The speculative-decoding model functions of the port against the JAX
reference at gpt_tiny f32 on the CPU: the k-wide verify forward, the
early-exit draft view, greedy and stochastic acceptance, the draft sample
and the per-row threefry keys of the stochastic lane.

Tolerances. The tensor-key threefry draws are integers and uniforms
computed from integer ops, so they are held bitwise. ``verify_tokens``
against k sequential ``decode_one_token`` calls of the port is not bitwise
on the CPU: the plain decode attention runs a window's rows one at a time,
but PyTorch's CPU GEMM rounds an M = B*k product differently from an M = B
one. Measured: logits 2.9e-6 apart at most (5.8e-7 of the largest
|logit|, 4.95), fp caches 1.8e-6, int8 codes equal and steps 1.3e-8 apart;
held to SEQ_TOL of the largest magnitude. The logits against the
reference's differ by summation-order ulps, held to VERIFY_TOL (a
scaled-int8 cache: KV8_TOL, the quantized tests' tolerance, since a K/V
code can move by one step across a rounding tie). Acceptance
outputs are integers (equal) and floats picked from the inputs (equal);
the draft's q against the reference's within PROB_TOL."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dist_oracle
from paddle_tpu.models import gpt as jg
from paddle_tpu.quantization import gpt_quant as jq
from paddle_tpu_torch.framework import prng
from paddle_tpu_torch.models import gpt as tg

torch.set_num_threads(1)

VERIFY_TOL = 1e-5
SEQ_TOL = 1e-6
KV8_TOL = 1e-3
PROB_TOL = 1e-6
VOCAB = 256


def _weights(seed=3):
    """The reference's init with the matrices and positions scaled up so
    greedy streams vary token to token."""
    tree = jax.device_get(jg.init_params(jg.gpt_tiny(), seed))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * 8.0
    tree["wte"] = tree["wte"] * 8.0
    tree["wpe"] = tree["wpe"] * 30.0
    return tree


@pytest.fixture(scope="module")
def tree():
    return _weights()


def _models(tree, kv=None, wq=None):
    jcfg = dataclasses.replace(jg.gpt_tiny(), decode_block=8,
                               kv_cache_dtype=kv, weight_quant=wq)
    tcfg = tg.gpt_tiny(decode_block=8, kv_cache_dtype=kv, weight_quant=wq)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if wq:
        jp = jq.quantize_gpt_params(jp, jcfg, jq.W_BITS[wq])
    return jcfg, jp, tcfg, tg.params_from_numpy(jax.device_get(jp), tcfg,
                                                device="cpu")


# ------------------------------------------------------------ prng keys
@pytest.mark.parametrize("shape", [(5,), (3, 4)])
def test_fold_in_rows_equals_vmap(shape):
    rng = np.random.default_rng(sum(shape))
    data = rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)
    base = jax.random.PRNGKey(77)
    ref = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        base, jnp.asarray(data.reshape(-1))).reshape(shape + (2,))
    got = prng.fold_in_rows(prng.PRNGKey(77), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.int64))
    # a tensor of keys folds row by row
    ref2 = jax.vmap(jax.random.fold_in)(ref.reshape(-1, 2),
                                        jnp.asarray(data.reshape(-1)))
    got2 = prng.fold_in_rows(got, torch.from_numpy(data))
    np.testing.assert_array_equal(
        got2.numpy().reshape(-1, 2), np.asarray(ref2).astype(np.int64))


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_spec_sample_key_equals_reference(lane):
    rng = np.random.default_rng(lane)
    seeds = rng.integers(-2 ** 31, 2 ** 31, 6).astype(np.int32)
    pos = rng.integers(0, 4096, 6).astype(np.int32)
    ref = jax.vmap(jg.spec_sample_key, in_axes=(0, 0, None))(
        jnp.asarray(seeds), jnp.asarray(pos), lane)
    got = tg.spec_sample_key(torch.from_numpy(seeds),
                             torch.from_numpy(pos), lane)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.int64))
    # deterministic in the triple only
    assert not torch.equal(got, tg.spec_sample_key(
        torch.from_numpy(seeds), torch.from_numpy(pos), (lane + 1) % 3))


@pytest.mark.parametrize("shape,lo,hi", [((), 0.0, 1.0), ((7,), 0.0, 1.0),
                                         ((2, 5), 0.25, 3.0)])
def test_uniform_rows_equals_vmap(shape, lo, hi):
    keys = jax.vmap(jg.spec_sample_key, in_axes=(0, 0, None))(
        jnp.arange(4, dtype=jnp.int32), jnp.arange(4, dtype=jnp.int32) * 9,
        1)
    ref = jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32, lo,
                                                hi))(keys)
    got = prng.uniform_rows(torch.from_numpy(
        np.asarray(keys).astype(np.int64)), shape, lo, hi)
    assert got.shape == (4,) + shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("V", [50, 300])
def test_categorical_rows_equals_vmap(V):
    rng = np.random.default_rng(V)
    lg = (rng.standard_normal((6, V)) * 2).astype(np.float32)
    lg[1, ::3] = -np.inf                 # filtered-out entries
    keys = jax.vmap(jg.spec_sample_key, in_axes=(0, 0, None))(
        jnp.arange(6, dtype=jnp.int32) + 100,
        jnp.arange(6, dtype=jnp.int32), 0)
    ref = jax.vmap(jax.random.categorical)(keys, jnp.asarray(lg))
    got = prng.categorical_rows(torch.from_numpy(
        np.asarray(keys).astype(np.int64)), torch.from_numpy(lg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="float32"):
        prng.categorical_rows(torch.zeros((1, 2), dtype=torch.int64),
                              torch.zeros((1, 4), dtype=torch.float64))


def test_host_and_tensor_keys_fold_alike():
    """A host pair and the same key as a tensor fold alike, and each row
    equals the one-key host fold_in."""
    key = prng.PRNGKey(5)
    d = torch.tensor([0, 1, 2 ** 32 - 1])
    rows = prng.fold_in_rows(key, d)
    np.testing.assert_array_equal(
        rows.numpy(), prng.fold_in_rows(torch.tensor(key), d).numpy())
    for i, v in enumerate(d.tolist()):
        assert tuple(rows[i].tolist()) == prng.fold_in(key, v)


# ---------------------------------------------------------- verify window
def _prefilled(jcfg, jp, tcfg, tp, paged, B=3, P=9, K=4, seed=0):
    """Both models prefilled on the same prompts (lengths 5, 9, 7), a
    window whose row 0 is the greedy token and rows 1.. random, and the
    port's caches (dense, or a pool of 4-page rows behind a table)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, VOCAB, (B, P)).astype(np.int32)
    lengths = np.array([5, 9, 7][:B], np.int32)
    jkc, jvc = jg.init_kv_cache(jcfg, B, 32)
    jl, jkc, jvc = jg.prefill(jp, jcfg, prompts, jkc, jvc,
                              lengths=jnp.asarray(lengths))
    window = np.concatenate(
        [np.asarray(jnp.argmax(jl, -1))[:, None],
         rng.integers(0, VOCAB, (B, K - 1))], 1).astype(np.int64)
    ptab = None
    if paged:
        kc, vc = tg.init_kv_cache(tcfg, 1 + 4 * B, 8, device="cpu")
        ptab = torch.arange(1, 1 + 4 * B, dtype=torch.int32).view(B, 4)
    else:
        kc, vc = tg.init_kv_cache(tcfg, B, 32, device="cpu")
    tl, kc, vc = tg.prefill(tp, tcfg, torch.from_numpy(prompts).long(), kc,
                            vc, lengths=torch.from_numpy(lengths).long(),
                            page_table=ptab)
    return (jkc, jvc), (kc, vc), ptab, window, lengths


def _clone(c):
    return tuple(t.clone() for t in c) if isinstance(c, tuple) else c.clone()


def _leaves(c):
    return c if isinstance(c, tuple) else (c,)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp", "kv8"])
def test_verify_equals_sequential_decode(tree, paged, kv):
    jcfg, jp, tcfg, tp = _models(tree, kv=kv)
    _, (kc, vc), ptab, window, lengths = _prefilled(jcfg, jp, tcfg, tp,
                                                    paged)
    pos = torch.from_numpy(lengths).long()
    kc_s, vc_s = _clone(kc), _clone(vc)
    seq = []
    for j in range(window.shape[1]):
        lg, _, _ = tg.decode_one_token(tp, tcfg,
                                       torch.from_numpy(window[:, j]),
                                       pos + j, kc_s, vc_s, page_table=ptab)
        seq.append(lg)
    vl, _, _ = tg.verify_tokens(tp, tcfg, torch.from_numpy(window), pos, kc,
                                vc, page_table=ptab)
    assert vl.shape == (3, 4, VOCAB) and vl.dtype == torch.float32
    _rel_close(vl, torch.stack(seq, 1))
    for a, b in zip(_leaves(kc) + _leaves(vc), _leaves(kc_s) + _leaves(vc_s)):
        if a.dtype == torch.int8:
            assert torch.equal(a, b)
        else:
            _rel_close(a, b)
    # greedy choices equal, the property acceptance rests on
    assert torch.equal(vl.argmax(-1), torch.stack(seq, 1).argmax(-1))


def _rel_close(got, want, tol=SEQ_TOL):
    """max |got - want| <= tol * max |want|."""
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp", "kv8"])
def test_verify_equals_reference(tree, kv):
    jcfg, jp, tcfg, tp = _models(tree, kv=kv)
    (jkc, jvc), (kc, vc), _, window, lengths = _prefilled(jcfg, jp, tcfg,
                                                          tp, False)
    ref, jkc, jvc = jg.verify_tokens(jp, jcfg, jnp.asarray(window, jnp.int32),
                                     jnp.asarray(lengths), jkc, jvc)
    got, kc, vc = tg.verify_tokens(tp, tcfg, torch.from_numpy(window),
                                   torch.from_numpy(lengths).long(), kc, vc)
    tol = VERIFY_TOL if kv is None else KV8_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)
    if kv is None:
        # the window's K/V as the reference wrote them
        for b, L in enumerate(lengths):
            for t, j in ((kc, jkc), (vc, jvc)):
                np.testing.assert_allclose(
                    t[:, b, :, L:L + 4].numpy(),
                    np.asarray(j)[:, b, :, L:L + 4], atol=VERIFY_TOL)


def test_verify_clips_positions_past_max_seq(tree):
    """Window rows past max_seq read the last positional embedding, as the
    reference's verify does (only rows past the cache limit get there)."""
    jcfg, jp, tcfg, tp = _models(tree)
    window = np.array([[5, 6, 7, 8]])
    pos = 62                                   # rows 2, 3 past max_seq 64
    jkc, jvc = jg.init_kv_cache(jcfg, 1, 72)
    ref, _, _ = jg.verify_tokens(jp, jcfg, jnp.asarray(window, jnp.int32),
                                 pos, jkc, jvc)
    kc, vc = tg.init_kv_cache(tcfg, 1, 72, device="cpu")
    got, _, _ = tg.verify_tokens(tp, tcfg, torch.from_numpy(window), pos, kc,
                                 vc)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=VERIFY_TOL,
                               rtol=VERIFY_TOL)


def test_dense_valid_keeps_masked_rows(tree):
    """A dense cache under ``valid``: masked rows write nothing and attend
    what the cache holds (the stochastic draft's first step)."""
    jcfg, jp, tcfg, tp = _models(tree)
    _, (kc, vc), _, window, lengths = _prefilled(jcfg, jp, tcfg, tp, False)
    before = (kc.clone(), vc.clone())
    valid = torch.tensor([True, False, True])
    pos = torch.from_numpy(lengths).long() - 1
    tg.decode_one_token(tp, tcfg, torch.from_numpy(window[:, 1]), pos, kc,
                        vc, valid=valid)
    for t, b in zip((kc, vc), before):
        assert torch.equal(t[:, 1], b[:, 1])
        assert not torch.equal(t[:, 0], b[:, 0])


# ------------------------------------------------------------ draft view
def test_early_exit_draft_and_compat(tree):
    jcfg, jp, tcfg, tp = _models(tree)
    dparams, dcfg = tg.early_exit_draft(tp, tcfg, 2)
    jd, jdcfg = jg.early_exit_draft(jp, jcfg, 2)
    assert dcfg.n_layers == jdcfg.n_layers == 2
    assert dparams["blocks"]["w_qkv"].shape[0] == 2
    # views: no weight is copied
    assert dparams["blocks"]["w_qkv"].data_ptr() == \
        tp["blocks"]["w_qkv"].data_ptr()
    for bad in (0, tcfg.n_layers + 1):
        with pytest.raises(ValueError, match="early-exit"):
            tg.early_exit_draft(tp, tcfg, bad)
    # the view decodes as the reference's draft
    kc, vc = tg.init_kv_cache(dcfg, 2, 16, device="cpu")
    jkc, jvc = jg.init_kv_cache(jdcfg, 2, 16)
    tok = np.array([3, 200])
    got, _, _ = tg.decode_one_token(dparams, dcfg, torch.from_numpy(tok), 0,
                                    kc, vc)
    ref, _, _ = jg.decode_one_token(jd, jdcfg, jnp.asarray(tok, jnp.int32),
                                    0, jkc, jvc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=VERIFY_TOL,
                               rtol=VERIFY_TOL)
    tg.check_draft_compat(tcfg, dcfg)
    with pytest.raises(ValueError, match="vocab"):
        tg.check_draft_compat(tcfg, tg.gpt_tiny(vocab_size=128))
    with pytest.raises(ValueError, match="max_seq"):
        tg.check_draft_compat(tcfg, tg.gpt_tiny(max_seq=32))


def test_early_exit_draft_of_quantized_tree(tree):
    jcfg, jp, tcfg, tp = _models(tree, kv="int8", wq="int8")
    dparams, dcfg = tg.early_exit_draft(tp, tcfg, 3)
    assert dparams["wte_s"] is tp["wte_s"]
    assert dparams["blocks"]["w_in_s"].shape[0] == 3
    jd, jdcfg = jg.early_exit_draft(jp, jcfg, 3)
    kc, vc = tg.init_kv_cache(dcfg, 1, 16, device="cpu")
    jkc, jvc = jg.init_kv_cache(jdcfg, 1, 16)
    got, _, _ = tg.decode_one_token(dparams, dcfg, torch.tensor([9]), 0, kc,
                                    vc)
    ref, _, _ = jg.decode_one_token(jd, jdcfg, jnp.asarray([9], jnp.int32),
                                    0, jkc, jvc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=1e-3)


# ----------------------------------------------------- greedy acceptance
def _onehot_logits(greedy, V=16):
    g = np.asarray(greedy)
    out = np.zeros(g.shape + (V,), np.float32)
    for idx in np.ndindex(g.shape):
        out[idx + (int(g[idx]),)] = 1.0
    return out


GREEDY_CASES = {
    # props, greedy after each position, pos, can, limit, eos
    "prefix": ([[9, 6, 7, 3]], [[6, 7, 8, 9]], [4], [True], 100, None),
    "eos": ([[9, 2, 7, 7]], [[2, 7, 7, 7]], [4], [True], 100, 2),
    "limit": ([[9, 6, 7, 8]], [[6, 7, 8, 9]], [98], [True], 100, None),
    "dead": ([[1, 1]], [[1, 1]], [4], [False], 100, None),
    "batch": ([[9, 6, 7, 3], [1, 2, 3, 4], [5, 5, 5, 5]],
              [[6, 7, 8, 9], [2, 3, 4, 5], [5, 5, 1, 5]], [4, 10, 97],
              [True, True, True], 100, 5),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_acceptance_equals_reference(case):
    props, greedy, pos, can, limit, eos = GREEDY_CASES[case]
    vlog = _onehot_logits(greedy)
    vlog = vlog + np.random.default_rng(1).standard_normal(
        vlog.shape).astype(np.float32) * 1e-3
    ref = jg.greedy_acceptance(jnp.asarray(props, jnp.int32),
                               jnp.asarray(vlog), jnp.asarray(pos),
                               jnp.asarray(can), limit, eos)
    got = tg.greedy_acceptance(torch.tensor(props), torch.from_numpy(vlog),
                               torch.tensor(pos), torch.tensor(can), limit,
                               eos)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_greedy_acceptance_rules():
    got = tg.greedy_acceptance(torch.tensor([[9, 6, 7, 3]]), torch.from_numpy(
        _onehot_logits([[6, 7, 8, 9]])), torch.tensor([4]),
        torch.tensor([True]), 100)
    accept, counts, n_adv, new_logits, last = got
    assert counts.tolist() == [3] and n_adv.tolist() == [3]
    assert accept.tolist() == [[True, True, True, False]]
    assert int(new_logits.argmax(-1)[0]) == 8 and int(last[0]) == 7
    _, counts, n_adv, _, last = tg.greedy_acceptance(
        torch.tensor([[9, 2, 7, 7]]),
        torch.from_numpy(_onehot_logits([[2, 7, 7, 7]])), torch.tensor([4]),
        torch.tensor([True]), 100, eos_token_id=2)
    assert counts.tolist() == [2] and n_adv.tolist() == [1]
    assert int(last[0]) == 2


# -------------------------------------------------- stochastic acceptance
V_SMALL = 12


def _draft_sample_inputs(B, seed):
    rng = np.random.default_rng(seed)
    lg = (rng.normal(0, 1.5, (B, V_SMALL))).astype(np.float32)
    temp = rng.choice([0.0, 0.7, 1.3], B).astype(np.float32)
    seeds = rng.integers(-50, 50, B).astype(np.int32)
    pos = rng.integers(0, 60, B).astype(np.int32)
    return lg, temp, seeds, pos


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.8),
                                         (6, 0.7)])
def test_spec_draft_sample_equals_reference(top_k, top_p):
    lg, temp, seeds, pos = _draft_sample_inputs(32, top_k + int(top_p * 10))
    rt, rq = jg.spec_draft_sample(jnp.asarray(lg), jnp.asarray(temp),
                                  jnp.asarray(seeds), jnp.asarray(pos),
                                  top_k, top_p)
    gt, gq = tg.spec_draft_sample(torch.from_numpy(lg), torch.from_numpy(temp),
                                  torch.from_numpy(seeds),
                                  torch.from_numpy(pos), top_k, top_p)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    np.testing.assert_allclose(gq.numpy(), np.asarray(rq), atol=PROB_TOL)
    # greedy rows propose their argmax
    g = temp == 0.0
    np.testing.assert_array_equal(gt.numpy()[g], lg.argmax(-1)[g])


def _stochastic_case(seed, B=16, k=4, eos=None, limit=40):
    """Random window state with every branch present: dead rows, pending
    rows, rows at the limit, greedy rows, eos proposals."""
    rng = np.random.default_rng(seed)
    V = V_SMALL
    temp = rng.choice([0.0, 0.6, 1.0, 1.4], B).astype(np.float32)
    seeds = rng.integers(0, 1000, B).astype(np.int32)
    pos = rng.integers(30, limit + 1, B).astype(np.int32)
    can = rng.random(B) < 0.85
    pend = rng.random(B) < 0.3
    d_lg = rng.normal(0, 1.5, (B, k, V)).astype(np.float32)
    v_lg = rng.normal(0, 1.5, (B, k, V)).astype(np.float32)
    base = rng.normal(0, 1.5, (B, V)).astype(np.float32)
    last = rng.integers(0, V, B).astype(np.int32)
    q = np.array(jg.filtered_probs(jnp.asarray(d_lg),
                                   jnp.asarray(temp)[:, None]))
    props = rng.integers(0, V, (B, k)).astype(np.int32)
    # draft proposals from q (so ratios are meaningful), eos sprinkled in
    for b in range(B):
        for j in range(k):
            props[b, j] = rng.choice(V, p=q[b, j] / q[b, j].sum())
    if eos is not None:
        props[rng.random((B, k)) < 0.15] = eos
    return (props, q, v_lg, base, temp, seeds, pos, can, limit, pend, last)


@pytest.mark.parametrize("seed,eos,top_k,top_p", [
    (0, None, 0, 0.0), (1, 3, 0, 0.0), (2, None, 5, 0.0), (3, 7, 0, 0.9),
    (4, 1, 6, 0.8)])
def test_stochastic_acceptance_equals_reference(seed, eos, top_k, top_p):
    (props, q, v_lg, base, temp, seeds, pos, can, limit, pend,
     last) = _stochastic_case(seed, eos=eos)
    ref = jg.stochastic_acceptance(
        jnp.asarray(props), jnp.asarray(q), jnp.asarray(v_lg),
        jnp.asarray(base), jnp.asarray(temp), jnp.asarray(seeds),
        jnp.asarray(pos), jnp.asarray(can), limit, jnp.asarray(pend),
        jnp.asarray(last), top_k=top_k, top_p=top_p, eos_token_id=eos)
    got = tg.stochastic_acceptance(
        torch.from_numpy(props).long(), torch.from_numpy(q),
        torch.from_numpy(v_lg), torch.from_numpy(base),
        torch.from_numpy(temp), torch.from_numpy(seeds),
        torch.from_numpy(pos).long(), torch.from_numpy(can), limit,
        torch.from_numpy(pend), torch.from_numpy(last).long(), top_k=top_k,
        top_p=top_p, eos_token_id=eos)
    names = ("accept", "counts", "n_adv", "new_logits", "last_tok",
             "pend_tok", "pend_valid")
    assert len(got) == len(names)
    # the reference returns the resample flag twice (pend_valid, resampled)
    np.testing.assert_array_equal(np.asarray(ref[6]), np.asarray(ref[7]))
    for n, g, r in zip(names, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=n)
    counts, pend_valid = got[1].numpy(), got[6].numpy()
    # every branch was exercised: a fresh row-0 rejection, a pending row,
    # a dead row, a full accept
    assert ((counts == 0) & can & ~pend & (pos < limit)).any()
    assert (pend & can).any() and (~can).any()
    assert pend_valid.any()
    assert (counts[~can] == 0).all()


def test_stochastic_limit_blocks_acceptance_and_resample():
    B = 8
    lg = torch.zeros((B, V_SMALL))
    seeds = torch.arange(B)
    pos = torch.full((B,), 50)
    props, q = tg.spec_draft_sample(lg, torch.ones(B), seeds, pos)
    out = tg.stochastic_acceptance(
        props[:, None], q[:, None], lg[:, None], lg, torch.ones(B), seeds,
        pos, torch.ones(B, dtype=torch.bool), 50,
        torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.long))
    assert out[1].tolist() == [0] * B
    assert not out[6].any()


def test_combined_draw_is_target_distributed():
    """Accepted draft token or (exactly when rejected) the pending residual
    resample: one draw from the target's filtered distribution."""
    B, temp = 4096, 0.9
    rng = np.random.default_rng(0)
    t_lg = torch.from_numpy(rng.normal(0, 1.5, (V_SMALL,)).astype(
        np.float32))
    d_lg = torch.from_numpy(rng.normal(0, 1.5, (V_SMALL,)).astype(
        np.float32))
    seeds, pos = torch.arange(B), torch.zeros(B, dtype=torch.long)
    tb = torch.full((B,), temp)
    props, q = tg.spec_draft_sample(d_lg.expand(B, -1), tb, seeds, pos)
    out = tg.stochastic_acceptance(
        props[:, None], q[:, None], t_lg.expand(B, 1, -1),
        t_lg.expand(B, -1), tb, seeds, pos,
        torch.ones(B, dtype=torch.bool), 1000,
        torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.long))
    counts, pend_tok, pend_val = out[1].numpy(), out[5].numpy(), \
        out[6].numpy()
    assert ((counts > 0) ^ pend_val).all()
    emitted = np.where(counts > 0, props.numpy(), pend_tok)
    target = tg.filtered_probs(t_lg[None], temp)[0].numpy()
    counts_e = dist_oracle.empirical(emitted, V_SMALL)
    ok, stat, dof = dist_oracle.chi_square_ok(counts_e, target)
    assert ok, f"chi2 {stat:.1f} vs dof {dof}"
    floor = dist_oracle.tv_noise_floor(B, V_SMALL)
    assert dist_oracle.tv_distance(counts_e, target) < 2.5 * floor
    # power: the raw proposals fail the same oracle
    assert not dist_oracle.chi_square_ok(
        dist_oracle.empirical(props.numpy(), V_SMALL), target)[0]

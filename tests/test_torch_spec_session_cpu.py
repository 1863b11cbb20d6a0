"""Speculative decoding through the port's GenerationSession and
ServingEngine against the JAX reference at gpt_tiny f32 on the CPU, on
the same weights (params_from_numpy): greedy spec streams equal the
spec-off streams and the reference's spec streams (early-exit and
separate draft; dense, paged with prefix reuse, scaled-int8 KV, int8 and
int4 weights); sampled spec streams equal the reference's token for token
(per-row temperatures and seeds, top-k, top-p; generate, admit and the
engine's submit); the spec counters equal the reference's; the target's
cache outside each verify window, and every shared page, is unchanged by
a spec tick; the first sampled token follows the target's distribution."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dist_oracle
from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.quantization import gpt_quant as jq
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.inference import GenerationSession
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.serving import ServingEngine

torch.set_num_threads(1)

VOCAB = 256
PS = 8
SPEC_KEYS = ("spec_accept_rate", "spec_accepted_total", "spec_emitted_total",
             "spec_proposed_total", "spec_resample_total", "spec_ticks",
             "spec_tokens_per_row_tick", "decode_ticks", "tokens_emitted")


def _scaled(tree, gain=8.0, wpe_gain=30.0):
    """Matrices and the position table scaled up, so greedy streams vary
    token to token."""
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * gain
    tree["wte"] = tree["wte"] * gain
    tree["wpe"] = tree["wpe"] * wpe_gain
    return tree


def _cfgs(**kw):
    kw.setdefault("decode_block", PS)
    kw.setdefault("prefill_chunk", 4)
    return dataclasses.replace(jg.gpt_tiny(), **kw), tg.gpt_tiny(**kw)


@pytest.fixture(scope="module")
def trees():
    """The target's and a separate 2-layer draft's reference weights."""
    target = _scaled(jax.device_get(jg.init_params(jg.gpt_tiny(), 3)))
    djc, _ = _cfgs(n_layers=2, hidden=32, n_heads=2)
    draft = _scaled(jax.device_get(jg.init_params(djc, 5)))
    return target, draft


def _model(tree, wq=None, kv=None, **kw):
    """(jcfg, jparams, tcfg, tparams); a quantized tree is quantized by the
    reference and carried across."""
    jcfg, tcfg = _cfgs(weight_quant=wq, kv_cache_dtype=kv, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if wq:
        jp = jq.quantize_gpt_params(jp, jcfg, jq.W_BITS[wq])
    return jcfg, jp, tcfg, tg.params_from_numpy(jax.device_get(jp), tcfg,
                                                device="cpu")


def _sessions(trees, draft=False, wq=None, kv=None, **kw):
    """The reference's session and the port's, built alike."""
    jcfg, jp, tcfg, tp = _model(trees[0], wq, kv)
    jk, tk = dict(kw), dict(kw)
    if draft:
        djc, djp, dtc, dtp = _model(trees[1], n_layers=2, hidden=32,
                                    n_heads=2)
        jk["spec_draft"], tk["spec_draft"] = (djp, djc), (dtp, dtc)
    for d in (jk, tk):
        d.setdefault("max_slots", 4)
        d.setdefault("max_prompt_len", 8)
        d.setdefault("max_len", 40)
    return JSession(jp, jcfg, **jk), GenerationSession(tp, tcfg, device="cpu",
                                                       **tk)


def _prompts(seed=1, n=3, p=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (n, p)).astype(np.int32), [3, 8, 5][:n]


def _spec_metrics(m):
    return {k: m[k] for k in SPEC_KEYS}


# ----------------------------------------------------------- greedy lane
GREEDY = {
    "early-k4": dict(spec_decode=4, spec_draft_layers=2),
    "early-k2-cut1": dict(spec_decode=2, spec_draft_layers=1),
    "early-k8-default-cut": dict(spec_decode=8),
    "draft-k3": dict(spec_decode=3, draft=True),
    "paged-early-k4": dict(spec_decode=4, spec_draft_layers=2,
                           kv_paged=True),
    "paged-draft-k4": dict(spec_decode=4, draft=True, kv_paged=True),
    "kv8-early-k4": dict(spec_decode=4, spec_draft_layers=2, kv="int8"),
    "w8-early-k3": dict(spec_decode=3, spec_draft_layers=2, wq="int8"),
    "w4kv8-paged-draft-k4": dict(spec_decode=4, draft=True, wq="int4",
                                 kv="int8", kv_paged=True),
}


@pytest.mark.parametrize("case", list(GREEDY))
def test_greedy_spec_equals_plain_and_reference(trees, case):
    kw = dict(GREEDY[case])
    js, ts = _sessions(trees, **kw)
    plain_kw = {k: v for k, v in kw.items() if k in ("wq", "kv", "kv_paged")}
    _, plain = _sessions(trees, **plain_kw)
    prompts, lengths = _prompts()
    ref = np.asarray(js.generate(prompts, lengths, max_new_tokens=20))
    got = ts.generate(prompts, lengths, max_new_tokens=20)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, plain.generate(prompts, lengths, max_new_tokens=20))
    assert _spec_metrics(ts.metrics()) == _spec_metrics(js.metrics())
    m = ts.metrics()
    assert m["spec_ticks"] > 0 and m["spec_accepted_total"] > 0
    assert m["spec_tokens_per_row_tick"] > 1.0
    if ts.kv_paged:
        assert ts.kv_page_stats() == js.kv_page_stats()


def test_greedy_rows_in_one_batch_accept_different_counts(trees):
    """Rows accepting different counts share each tick, and every row's
    stream equals its solo plain run."""
    _, ts = _sessions(trees, spec_decode=4, spec_draft_layers=2)
    prompts, lengths = _prompts(seed=6, n=3)
    slots = ts.admit(prompts, lengths)
    streams, mixed = {s: [] for s in slots}, False
    for _ in range(6):
        em = ts.spec_step()
        mixed |= len({len(em.get(s, [])) for s in slots}) > 1
        for s in slots:
            streams[s].extend(em.get(s, []))
    assert mixed
    for i, s in enumerate(slots):
        _, solo = _sessions(trees, max_slots=1)
        ref = solo.generate(prompts[i:i + 1, :lengths[i]],
                            max_new_tokens=len(streams[s]))
        assert streams[s] == list(ref[0])


# -------------------------------------------------------- stochastic lane
SAMPLED = {
    "early-temp": dict(spec_decode=4, spec_draft_layers=2, temperature=0.8),
    "early-topk": dict(spec_decode=3, spec_draft_layers=2, temperature=1.0,
                       top_k=20),
    "early-topp-paged": dict(spec_decode=4, spec_draft_layers=1,
                             temperature=1.0, top_p=0.9, kv_paged=True),
    "draft": dict(spec_decode=4, draft=True, temperature=0.9),
    "draft-paged-topk-topp": dict(spec_decode=3, draft=True, temperature=1.1,
                                  top_k=30, top_p=0.8, kv_paged=True),
    "kv8-early": dict(spec_decode=4, spec_draft_layers=2, temperature=0.7,
                      kv="int8"),
    "forced-per-row": dict(spec_decode=4, spec_draft_layers=2,
                           spec_sample=True),
}


@pytest.mark.parametrize("case", list(SAMPLED))
def test_sampled_spec_streams_equal_reference(trees, case):
    kw = dict(SAMPLED[case])
    js, ts = _sessions(trees, **kw)
    assert ts.spec_sample and js.spec_sample
    prompts, lengths = _prompts(seed=2)
    rows = dict(seeds=[41, -7, 2 ** 31 - 1])
    if case == "forced-per-row":
        rows["temperatures"] = [0.9, 0.0, 1.3]
    ref = np.asarray(js.generate(prompts, lengths, max_new_tokens=16,
                                 **rows))
    got = ts.generate(prompts, lengths, max_new_tokens=16, **rows)
    np.testing.assert_array_equal(got, ref)
    assert _spec_metrics(ts.metrics()) == _spec_metrics(js.metrics())
    m = ts.metrics()
    assert m["spec_resample_total"] > 0


def test_sampled_ticks_equal_reference_tick_by_tick(trees):
    """admit() + spec_step(): every tick's emitted lists (pending resamples
    included) equal the reference's, with rows joining mid-flight."""
    kw = dict(spec_decode=3, spec_draft_layers=2, temperature=0.9, top_k=40)
    js, ts = _sessions(trees, **kw)
    prompts, lengths = _prompts(seed=3)
    for sess in (js, ts):
        sess.admit(prompts[:2], lengths[:2], temperatures=[0.9, 1.2],
                   seeds=[5, 6])
    for tick in range(14):
        if tick == 3:
            for sess in (js, ts):
                sess.admit(prompts[2:], lengths[2:], seeds=[9])
        je, te = js.spec_step(), ts.spec_step()
        assert te == {s: [int(t) for t in v] for s, v in je.items()}, tick
        assert [ts.is_active(s) for s in range(4)] == \
            [js.is_active(s) for s in range(4)]


def test_temperature_zero_rows_reproduce_greedy(trees):
    _, plain = _sessions(trees)
    _, armed = _sessions(trees, spec_decode=3, spec_draft_layers=2,
                         temperature=0.8)
    prompts, lengths = _prompts(seed=4, n=2)
    np.testing.assert_array_equal(
        plain.generate(prompts, lengths, max_new_tokens=12),
        armed.generate(prompts, lengths, max_new_tokens=12,
                       temperatures=[0.0, 0.0]))


def test_same_seed_equal_across_sessions_and_cohorts(trees):
    kw = dict(spec_decode=3, spec_draft_layers=2, temperature=0.9)
    prompts, lengths = _prompts(seed=5)

    def run(seeds, n=3, **extra):
        _, s = _sessions(trees, **kw, **extra)
        return s.generate(prompts[:n], lengths[:n], max_new_tokens=10,
                          seeds=seeds)

    a, b, c = run([11, 22, 33]), run([11, 22, 33]), run([12, 22, 33])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[0], c[0])        # the seed moves the row
    np.testing.assert_array_equal(a[1:], c[1:])  # and only that row
    # a row's stream depends on (prompt, temperature, seed) alone, not on
    # its batch or its slot: solo runs, and a paged session, agree
    for i in range(3):
        _, solo = _sessions(trees, max_slots=1, **kw)
        np.testing.assert_array_equal(
            solo.generate(prompts[i:i + 1, :lengths[i]], max_new_tokens=10,
                          seeds=[[11, 22, 33][i]])[0], a[i])
    np.testing.assert_array_equal(run([11, 22, 33], kv_paged=True), a)


def test_first_sampled_token_follows_the_target(trees):
    """The first token of many seeded rows at one prompt, with the whole
    lane (draft, verify, acceptance, pending resamples) in the loop,
    passes the chi-square/TV oracle against the target's filtered
    distribution."""
    temp, n_rounds, B = 0.8, 16, 16
    _, tcfg = _cfgs()
    tp = _model(trees[0])[3]
    prompt = np.array([1, 2, 3, 4], np.int32)
    kc, vc = tg.init_kv_cache(tcfg, 1, 16, device="cpu")
    lg, _, _ = tg.prefill(tp, tcfg, torch.from_numpy(prompt)[None].long(),
                          kc, vc)
    target = tg.filtered_probs(lg, temp)[0].numpy()
    _, sess = _sessions(trees, max_slots=B, max_prompt_len=4, max_len=24,
                        temperature=temp, spec_decode=3, spec_draft_layers=2)
    first = []
    for r in range(n_rounds):
        slots = sess.admit(np.tile(prompt, (B, 1)),
                           seeds=[1000 + r * B + i for i in range(B)])
        while not all(sess.generated_count(s) >= 1 for s in slots):
            sess.spec_step()
        sess.freeze(slots)
        first += [sess.evict(s)[0] for s in slots]
    counts = dist_oracle.empirical(first, VOCAB)
    ok, stat, dof = dist_oracle.chi_square_ok(counts, target)
    assert ok, f"chi2 {stat:.1f} vs dof {dof}"
    floor = dist_oracle.tv_noise_floor(len(first), VOCAB)
    assert dist_oracle.tv_distance(counts, target) < 2.0 * floor
    assert sess.metrics()["spec_resample_total"] > 0


# ------------------------------------------------------------------ engine
def _engine_trace(seed=21):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, VOCAB, (16,)).astype(np.int32)
    trace = []
    for i in range(7):
        p = (np.concatenate([shared, rng.integers(1, VOCAB, (3 + i,))])
             if i % 2 == 0 else rng.integers(1, VOCAB, (9 + i,)))
        trace.append((p.astype(np.int32), 6 + i % 4))
    return trace


def _drive(eng, sess, sampled):
    reqs = []
    for i, (p, m) in enumerate(_engine_trace()):
        kw = dict(temperature=[None, 0.0, 1.2][i % 3], seed=100 + i) \
            if sampled else {}
        reqs.append(eng.submit(p, max_new_tokens=m, **kw))
    pages = []
    while eng.pending:
        eng.poll()
        if sess.kv_paged:
            pages.append(tuple(int(x) for x in sess.kv_page_stats()))
        assert len(pages) < 2000
    assert all(r.state.value == "done" for r in reqs)
    assert all(len(r.output) == m for r, (_, m) in zip(reqs, _engine_trace()))
    out = ([list(map(int, r.output)) for r in reqs],
           [int(r.prefix_hit_tokens) for r in reqs], pages,
           _spec_metrics(eng.metrics()))
    eng.close()
    return out


ENGINE = {
    "dense-early-greedy": dict(spec_decode=4, spec_draft_layers=2),
    "paged-early-sampled": dict(spec_decode=4, spec_draft_layers=2,
                                temperature=0.7, kv_paged=True),
    "paged-draft-greedy": dict(spec_decode=3, draft=True, kv_paged=True),
    "dense-draft-sampled": dict(spec_decode=3, draft=True, temperature=0.9),
}


@pytest.mark.parametrize("case", list(ENGINE))
def test_engine_spec_equals_reference(trees, case):
    kw = dict(ENGINE[case])
    sampled = "temperature" in kw
    js, ts = _sessions(trees, max_prompt_len=32, **kw)
    ekw = dict(max_queue=64, prefill_chunk=8, prefix_cache_blocks=16)
    ref = _drive(JEngine(js, **ekw), js, sampled)
    got = _drive(ServingEngine(ts, device="cpu", **ekw), ts, sampled)
    assert got == ref
    assert sum(got[1]) > 0                 # prefix reuse was in the loop
    if not sampled:
        # the spec-off engine serves the same streams
        _, plain = _sessions(trees, max_prompt_len=32,
                             kv_paged=kw.get("kv_paged", False))
        assert _drive(ServingEngine(plain, device="cpu", **ekw), plain,
                      False)[0] == got[0]


def test_engine_temperature_resolution(trees):
    _, greedy = _sessions(trees, max_prompt_len=16)
    eng = ServingEngine(greedy, max_queue=4, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        eng.submit(np.array([1, 2, 3]), max_new_tokens=4, temperature=0.7)
    assert eng.submit(np.array([1, 2, 3]), 4).temperature == 0.0
    eng.close()
    _, armed = _sessions(trees, max_prompt_len=16, temperature=0.8,
                         spec_decode=3, spec_draft_layers=2)
    eng = ServingEngine(armed, max_queue=4, device="cpu")
    r = eng.submit(np.array([1, 2, 3]), max_new_tokens=4)
    assert r.temperature == 0.8 and r.seed == r.seq
    explicit = eng.submit(np.array([1, 2, 3]), max_new_tokens=4,
                          temperature=0.0, seed=9)
    assert explicit.temperature == 0.0 and explicit.seed == 9
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        eng.submit(np.array([1, 2, 3]), max_new_tokens=4, temperature=-1.0)
    eng.run()
    assert r.state.value == explicit.state.value == "done"
    eng.close()


# ------------------------------------------------------------ the cache
def _leaves(c):
    return c if isinstance(c, tuple) else (c,)


def _snapshot(sess):
    return [t.clone() for c in (sess._kc, sess._vc) for t in _leaves(c)]


CACHE = {
    "dense-early-greedy": dict(spec_decode=4, spec_draft_layers=2),
    "dense-early-sampled": dict(spec_decode=4, spec_draft_layers=2,
                                temperature=1.0),
    "kv8-early-sampled": dict(spec_decode=3, spec_draft_layers=3,
                              temperature=1.0, kv="int8"),
    "paged-early-sampled": dict(spec_decode=4, spec_draft_layers=2,
                                temperature=1.0, kv_paged=True),
    "paged-draft-sampled": dict(spec_decode=4, draft=True, temperature=1.0,
                                kv_paged=True),
}


@pytest.mark.parametrize("case", list(CACHE))
def test_spec_tick_leaves_cache_outside_window(trees, case):
    """Rows whose prompt ends on a page the prefix pool shares: a spec
    tick (whose stochastic draft re-consumes the token at pos - 1) leaves
    every cache position outside [pos, pos + k) of every row, and every
    shared page, bit for bit as it was."""
    kw = dict(CACHE[case])
    _, sess = _sessions(trees, max_prompt_len=24, **kw)
    k = sess.spec_k
    prompt = np.random.default_rng(9).integers(1, VOCAB, (24,))
    a = sess.alloc_slot()
    sess.prefill_chunks([(a, prompt[:16], 0, True)], 16)
    spans = [sess.read_prefix_block(a, 0, 16)]
    b = sess.alloc_slot()
    assert sess.copy_prefix_into(b, spans) == 16
    sess.prefill_chunks([(b, prompt[16:], 16, True)], 8)
    if sess.kv_paged:
        assert sess.kv_page_stats()[2] == 2        # two shared pages
    for tick in range(4):
        pos = [int(p) for p in sess._pos]
        live = [sess.is_active(s) for s in range(sess.max_slots)]
        before = _snapshot(sess)
        sess.spec_step()
        after = _snapshot(sess)
        for x, y in zip(before, after):
            for s in range(sess.max_slots):
                if not live[s]:
                    continue
                lo, hi = pos[s], pos[s] + k
                if sess.kv_paged:
                    pages = sess._ptab[s]
                    xs, ys = x[:, pages], y[:, pages]     # [L, nb, H, ps..]
                    xs = xs.movedim(2, 1).flatten(2, 3)   # [L, H, S..]
                    ys = ys.movedim(2, 1).flatten(2, 3)
                else:
                    xs, ys = x[:, s], y[:, s]
                assert torch.equal(xs[:, :, :lo], ys[:, :, :lo]), (tick, s)
                assert torch.equal(xs[:, :, hi:], ys[:, :, hi:]), (tick, s)
            if sess.kv_paged:
                shared = np.nonzero(sess._page_ref > 1)[0]
                assert len(shared)
                assert torch.equal(x[:, shared], y[:, shared])


# -------------------------------------------------------------- the pool
def test_paged_grants_hold_the_spec_headroom(trees):
    js, ts = _sessions(trees, spec_decode=4, spec_draft_layers=2,
                       kv_paged=True, max_prompt_len=24)
    for need in (1, 4, 5, 12, 13, 36, None):
        assert ts.alloc_slot(need) == js.alloc_slot(need)
        assert ts.kv_page_stats() == js.kv_page_stats()
        assert ts.kv_row_pages_total() == js.kv_row_pages_total()
        for sess in (ts, js):
            sess.release_slot(0)
    assert ts._phys_len == js._phys_len == 48      # pad(40 + 4, 8)


# ----------------------------------------------------------- the errors
def test_spec_errors(trees, monkeypatch):
    tcfg = _cfgs()[1]
    tp = _model(trees[0])[3]
    mk = lambda **kw: GenerationSession(tp, tcfg, max_slots=2, device="cpu",
                                        **kw)
    bad_cfg = tg.gpt_tiny(vocab_size=128, n_layers=1)
    bad = tg.init_params(bad_cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        mk(spec_decode=4, spec_draft=(bad, bad_cfg))
    assert mk(spec_decode=4, spec_draft_layers=2, temperature=0.7
              ).spec_sample
    with pytest.raises(ValueError, match="spec_sample"):
        mk(spec_decode=4, temperature=0.7, spec_sample=False)
    with pytest.raises(ValueError, match="spec_sample"):
        mk(spec_sample=True)
    assert not mk(spec_decode=4).spec_sample
    with pytest.raises(ValueError, match="spec_draft_layers"):
        mk(spec_decode=4, spec_draft_layers=5)
    with pytest.raises(ValueError, match=">= 0"):
        mk(spec_decode=-1)
    # the decode kernel's window bound holds on every device
    with pytest.raises(ValueError, match="MAX_Q = 8"):
        mk(spec_decode=9)
    assert mk(spec_decode=8).spec_k == 8
    off = mk(spec_decode=1)
    assert off.spec_k == 0
    with pytest.raises(RuntimeError, match="spec_decode"):
        off.spec_step()
    with pytest.raises(RuntimeError, match="spec_decode"):
        off.spec_tick([(0, [1], 0, True)], 4)
    with pytest.raises(ValueError, match="temperature"):
        off.set_sampling(0, 0.5, 1)
    off.set_sampling(0, 0.0, 1)          # greedy on a greedy session: fine
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "3")
    assert mk().spec_k == 3
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "12")
    with pytest.raises(ValueError, match="MAX_Q"):
        mk()
    monkeypatch.delenv("PADDLE_TPU_SPEC_DECODE")
    assert mk().spec_k == 0

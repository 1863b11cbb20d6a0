"""The serving steps as captured CUDA graphs (framework/cuda_graph.py), on
the CPU at gpt_tiny f32, where no graph is captured and every tick body
runs directly: the device key the graphed ticks draw from (framework/
prng.py's tensor-key ``split`` and ``categorical``) equals the host key
and jax bit for bit; every tensor a tick reads and writes keeps its
storage across a whole serving trace; the tick bodies make no host read;
and the warm-up tick a graph starts with is a real tick that changes
nothing else, so the sampled and stochastic-spec streams that run through
it equal the reference's token for token."""
import contextlib
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.framework import cuda_graph, prng
from paddle_tpu_torch.inference import GenerationSession, generation
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.serving import ServingEngine

torch.set_num_threads(1)
VOCAB = 256
PS = 8


@pytest.fixture(scope="module")
def models():
    """The target's and a separate 2-layer draft's weights, scaled so
    streams vary token to token: (jcfg, jparams, tcfg, tparams) each."""
    out = []
    for seed, kw in ((3, {}), (5, dict(n_layers=2, hidden=32, n_heads=2))):
        jcfg = dataclasses.replace(jg.gpt_tiny(), decode_block=PS,
                                   prefill_chunk=4, **kw)
        tcfg = tg.gpt_tiny(decode_block=PS, prefill_chunk=4, **kw)
        tree = jax.device_get(jg.init_params(jcfg, seed))
        for name in ("w_qkv", "w_o", "w_in", "w_out"):
            tree["blocks"][name] = tree["blocks"][name] * 8.0
        tree["wte"] = tree["wte"] * 8.0
        tree["wpe"] = tree["wpe"] * 30.0
        out.append((jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
                    tg.params_from_numpy(tree, tcfg, device="cpu")))
    return out


# session kinds: every tick body, dense and paged
CASES = {
    "plain-dense": dict(),
    "plain-paged-sampled": dict(temperature=0.8, top_k=40, kv_paged=True),
    "spec-greedy-dense-early": dict(spec_decode=4, spec_draft_layers=1),
    "spec-greedy-paged-draft": dict(spec_decode=3, draft=True,
                                    kv_paged=True),
    "spec-stochastic-dense-early": dict(spec_decode=4, spec_draft_layers=1,
                                        temperature=0.9),
    "spec-stochastic-paged-draft": dict(spec_decode=3, draft=True,
                                        temperature=1.1, top_p=0.9,
                                        kv_paged=True),
}


def _session(models, ref=False, draft=False, **kw):
    (jcfg, jp, tcfg, tp), (djc, djp, dtc, dtp) = models
    kw = dict(max_slots=4, max_prompt_len=16, max_len=40, **kw)
    if ref:
        if draft:
            kw["spec_draft"] = (djp, djc)
        return JSession(jp, jcfg, **kw)
    if draft:
        kw["spec_draft"] = (dtp, dtc)
    return GenerationSession(tp, tcfg, device="cpu", **kw)


def _tick(sess):
    return sess.spec_step() if sess.spec_k else sess.step()


def _prompts(seed=1, n=3, p=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (n, p)).astype(np.int32), [3, 8, 5][:n]


# ------------------------------------------------------------- (a) keys
@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1])
def test_tensor_key_split_and_categorical_equal_host_and_jax(seed):
    hk, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    tk = torch.tensor(hk, dtype=torch.int64)
    for n in (2, 3, 5):
        want = np.asarray(jax.random.split(jk, n)).astype(np.int64).tolist()
        assert prng.split(tk, n).tolist() == want
        assert [list(k) for k in prng.split(hk, n)] == want
    logits = np.random.default_rng(seed & 0xFF).standard_normal(
        (4, 50304)).astype(np.float32)
    for _ in range(3):          # the session's key, sub = split(key) chain
        jk, jsub = jax.random.split(jk)
        hk, hsub = prng.split(hk)
        tsub = prng.split(tk)
        tk.copy_(tsub[0])       # in place, as the graphed tick updates it
        assert tk.tolist() == list(hk) == np.asarray(jk).tolist()
        want = np.asarray(jax.random.categorical(jsub, jnp.asarray(logits)))
        got = prng.categorical(tsub[1], torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, prng.categorical(hsub, torch.from_numpy(
            logits)))
        np.testing.assert_array_equal(
            prng.bits(tsub[1], (4, 33), "cpu").numpy(),
            np.asarray(jax.random.bits(jsub, (4, 33), jnp.uint32)))


# ----------------------------------------------------- (b) fixed storage
@pytest.mark.parametrize("case", list(CASES))
def test_tick_state_keeps_its_storage_across_a_trace(models, case):
    """Whole and chunked admission, freeze, evict, page grants and frees,
    prefix copies (the engine's prefix pool), plain or spec ticks, chunk
    ticks at two width buckets: every tick-state tensor and cache leaf
    (the chunk batch's storage too) keeps its data_ptr."""
    sess = _session(models, **CASES[case])
    ptrs = {n: t.data_ptr() for n, t in sess._tick_state().items()}
    assert "_key" in ptrs and "_dump_dev" in ptrs
    assert ("_ptab_dev" in ptrs) == sess.kv_paged
    assert ("_pend_tok" in ptrs) == sess.spec_sample
    assert "_chunk_dev" in ptrs

    def same(where):
        now = {n: t.data_ptr() for n, t in sess._tick_state().items()}
        assert now == ptrs, where

    prompts, lengths = _prompts()
    slots = sess.admit(prompts[:2], lengths[:2])
    for _ in range(3):
        _tick(sess)
    same("whole admission and ticks")
    sess.freeze(slots[:1])
    _tick(sess)
    for s in slots:
        sess.evict(s)
    same("freeze and evict")
    rng = np.random.default_rng(7)
    shared = rng.integers(0, VOCAB, 2 * PS)
    trace = [np.concatenate([shared, rng.integers(0, VOCAB, n)])
             for n in (3, 5, 2)]
    eng = ServingEngine(sess, max_queue=8, prefill_chunk=4,
                        width_buckets=(2,), prefix_cache_blocks=8,
                        device="cpu")
    widths = []
    tick = sess.spec_tick if sess.spec_k else sess.fused_tick
    sess.spec_tick = sess.fused_tick = \
        lambda chunks, width, **kw: widths.append(width) or tick(
            chunks, width, **kw)
    reqs = []
    for p in trace:             # one at a time: the pool promotes, then hits
        reqs.append(eng.submit(p, max_new_tokens=6))
        eng.run()
    assert all(len(r.output) == 6 for r in reqs)
    assert eng.metrics()["prefix_cache"]["hits"] > 0
    assert set(widths) == {2, 4}
    same("chunked admission, prefix copies, page grants and frees")
    eng.close()


# ---------------------------------------------------- (c) no host reads
@contextlib.contextmanager
def _no_host_reads(sess):
    """Raise on every host read of a tensor and on any read of the
    session's host mirrors."""
    def trap(*_a, **_k):
        raise AssertionError("host read inside a tick body")

    names = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
             "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    cls = type(sess)
    guarded = type("Guarded", (cls,), {
        n: property(trap) for n in ("_host_pos", "_dump", "_ptab")})
    for n in names:
        setattr(torch.Tensor, n, trap)
    sess.__class__ = guarded
    try:
        yield
    finally:
        sess.__class__ = cls
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("case", list(CASES))
def test_tick_body_makes_no_host_read(models, case, monkeypatch):
    """The device body of each tick kind under a guard against host reads,
    with dead rows at their dump positions; its output equals an eager
    tick of a twin session. The plain decode attention stands in for the
    kernel in its full-buffer form, which (like the kernel) reads the
    positions on the device: the bounded form sizes its loop on the
    host."""
    monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", "full")
    sess, twin = _session(models, **CASES[case]), _session(models,
                                                           **CASES[case])
    prompts, lengths = _prompts(seed=4)
    for s in (sess, twin):
        s.admit(prompts, lengths)
        s.alloc_slot(need_tokens=12)     # a reserved, dead row
        _tick(s)
    body = sess._spec_body if sess.spec_k else sess._decode_body
    with _no_host_reads(sess):
        out = body()
    want = twin._spec_decode() if twin.spec_k else twin._decode()
    np.testing.assert_array_equal(out.numpy(), want)
    for n, t in twin._tick_state().items():
        assert torch.equal(sess._tick_state()[n], t), n


@pytest.mark.parametrize("kind", ["chunk", "tick"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunk_bodies_make_no_host_read(models, case, kind, monkeypatch):
    """The chunk tick's body and the fused (or fused spec) tick's body,
    at a width bucket, under the host-read guard: one row mid-prefill and
    one finalizing beside two live rows. The tick state and caches equal
    a twin session's after the same tick through the public call."""
    monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", "full")
    sess, twin = _session(models, **CASES[case]), _session(models,
                                                           **CASES[case])
    prompts, lengths = _prompts(seed=6)
    W = 4
    for s in (sess, twin):
        s.admit(prompts[:2], lengths[:2])
        mid, fin = s.alloc_slot(need_tokens=20), s.alloc_slot(need_tokens=12)
        if s.spec_sample:
            s.set_sampling(fin, 0.7, 99)
        _tick(s)
    chunks = [(mid, prompts[2, :W], 0, False), (fin, prompts[2, :3], 0, True)]
    sess._assemble_chunks(chunks, W)
    if sess.kv_paged:
        sess._sync_ptab()
    body = {"chunk": sess._chunk_body, "tick": sess._spec_fused_body
            if sess.spec_k else sess._fused_body}[kind]
    with _no_host_reads(sess):
        body(W)
    if kind == "chunk":
        twin.prefill_chunks(chunks, W)
    else:
        (twin.spec_tick if twin.spec_k else twin.fused_tick)(chunks, W)
    for n, t in twin._tick_state().items():
        assert torch.equal(sess._tick_state()[n], t), n
    assert twin._activ[fin] and not twin._activ[mid]
    assert twin._dump_dev[mid] == W and not twin._dump_dirty


# ------------------------------------------------- (d) the warm-up tick
class _EveryTickWarmsUp(dict):
    """A session's graph table that keeps no graph: every tick builds a
    fresh TickGraph, whose first call is the warm-up."""

    def __setitem__(self, key, value):
        pass


def _warm_up_ticks(sess, monkeypatch):
    monkeypatch.setattr(generation, "graphed", lambda device: True)

    def no_capture(self):
        raise AssertionError("no capture on the CPU")

    monkeypatch.setattr(cuda_graph.TickGraph, "_capture", no_capture)
    sess._graphs = _EveryTickWarmsUp()


@pytest.mark.parametrize("case", ["plain-paged-sampled",
                                  "spec-stochastic-paged-draft"])
def test_warm_up_tick_is_a_real_tick(models, case, monkeypatch):
    """Every tick through TickGraph's warm-up (no capture on the CPU): the
    sampled and stochastic-spec streams equal the reference session's
    token for token, and the tick state and caches end bitwise equal to
    a twin session's that ran the bodies directly."""
    kw = CASES[case]
    ref, sess, twin = (_session(models, ref=True, **kw),
                       _session(models, **kw), _session(models, **kw))
    _warm_up_ticks(sess, monkeypatch)
    prompts, lengths = _prompts(seed=2)
    rows = dict(seeds=[41, -7, 2 ** 31 - 1]) if sess.spec_sample else {}
    want = np.asarray(ref.generate(prompts, lengths, max_new_tokens=12,
                                   **rows))
    got = sess.generate(prompts, lengths, max_new_tokens=12, **rows)
    np.testing.assert_array_equal(got, want)
    monkeypatch.undo()
    np.testing.assert_array_equal(
        twin.generate(prompts, lengths, max_new_tokens=12, **rows), want)
    for n, t in twin._tick_state().items():
        assert torch.equal(sess._tick_state()[n], t), n


def test_a_sessions_graph_does_not_keep_it_alive(models, monkeypatch):
    """A session's tick graph holds the tick body weakly: with the cycle
    collector off (as it is during a capture), dropping the session frees
    it, and its graphs with it, at once."""
    sess = _session(models)
    monkeypatch.setattr(generation, "graphed", lambda device: True)
    sess.admit(*_prompts())
    sess.step()                     # the warm-up tick builds the graph
    assert "plain" in sess._graphs
    ref = weakref.ref(sess)
    gc.disable()
    try:
        del sess
        assert ref() is None
    finally:
        gc.enable()

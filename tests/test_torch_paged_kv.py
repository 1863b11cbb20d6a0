"""The port's paged KV cache and prefix KV reuse on the CPU, against the JAX
reference (tests/test_paged_kv.py is the reference's own oracle):

- the paged decode attention's plain versions against the Pallas paged
  kernel in interpret mode and the XLA paged fallback (1e-5), garbage in
  the scratch page and in unowned pages changing nothing, and the paged
  plain version equal to the dense one over the gathered view, bit for
  bit;
- the pool helpers (``paged_gather``, ``_page_scatter``, ``paged_write``)
  against the reference's on the same pool;
- the prefix pool's chain keys and its match / insert / peek / eviction
  decisions against the reference's ``PrefixCache``;
- within the port: paged sessions serve the streams of dense ones, grant
  need-sized tables, backpressure on pages and free a shared page only at
  its last reader;
- the paged engine with prefix reuse against the reference's paged engine
  on one seeded trace: equal streams, prefix hits and page counters.

gpt_tiny(n_layers=2, decode_block=8) in f32; page size 8 (the Pallas
kernel runs 8-row pages in interpret mode)."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import prefix_cache as jpc
from paddle_tpu_torch.inference import GenerationSession
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.quantization import quantize_gpt_params
from paddle_tpu_torch.quantization.gpt_quant import quantize_rows
from paddle_tpu_torch.serving import (PageSpan, PrefixCache, RequestState,
                                      ServingEngine)
from paddle_tpu_torch.serving import prefix_cache as tpc

jda = importlib.import_module("paddle_tpu.ops.pallas.decode_attention")
jprim = importlib.import_module("paddle_tpu.ops.pallas.primitives")

torch.set_num_threads(1)
F32_TOL = 1e-5
PS = 8                      # page size = decode_block
VOCAB = 256


def _interpret(fn, *args, **kw):
    old = jprim.interpret()
    jprim.set_interpret(True)
    try:
        return fn(*args, **kw)
    finally:
        jprim.set_interpret(old)


def _j(x):
    """numpy (or a (codes, steps) pair of it) -> jnp."""
    return tuple(map(jnp.asarray, x)) if isinstance(x, tuple) \
        else jnp.asarray(x)


def _t(x):
    """numpy (or a pair of it) -> a torch copy."""
    return tuple(torch.tensor(a) for a in x) if isinstance(x, tuple) \
        else torch.tensor(x)


# ================================================================ kernels
def _pool_case(quant, Q, seed=0, B=3, H=2, d=16, nb=4, P=16):
    """q, K/V pools, a shuffled page table (rows own 4, 2 and 3 pages; dead
    entries name the scratch page 0), positions inside each row's pages,
    and the pages no row owns."""
    rng = np.random.default_rng(seed + 10 * Q + quant)
    q = rng.standard_normal((B, H, Q, d)).astype(np.float32)

    def leaf():
        x = rng.standard_normal((P, H, PS, d)).astype(np.float32)
        if not quant:
            return x
        codes, steps = quantize_rows(torch.from_numpy(x))
        return codes.numpy(), steps.numpy()

    k, v = leaf(), leaf()
    perm = rng.permutation(np.arange(1, P))
    ptab = np.zeros((B, nb), np.int32)
    owned, i = (4, 2, 3), 0
    for b, n in enumerate(owned):
        ptab[b, :n] = perm[i:i + n]
        i += n
    pos = np.asarray([n * PS - Q - 2 * b for b, n in enumerate(owned)],
                     np.int32)
    return q, k, v, ptab, pos, perm[i:]


@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_plain_matches_interpret_kernel_and_xla(quant, Q, monkeypatch):
    q, k, v, ptab, pos, _ = _pool_case(quant, Q)
    scale = 0.25
    got = da.decode_attention(_t(q), _t(k), _t(v), torch.tensor(pos), scale,
                              page_table=torch.tensor(ptab))
    wrapper = da.decode_attention_paged_q8 if quant \
        else da.decode_attention_paged
    assert torch.equal(got, wrapper(_t(q), _t(k), _t(v), torch.tensor(pos),
                                    torch.tensor(ptab), scale))
    args = (_j(q), _j(k), _j(v), jnp.asarray(pos))
    pallas = _interpret(jda._pallas_paged_decode_attention, *args,
                        jnp.asarray(ptab), scale)
    xla = jda._xla_bounded_decode_attention(*args, scale, PS,
                                            ptab=jnp.asarray(ptab))
    for ref in (pallas, xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=F32_TOL, rtol=F32_TOL)
    # the full-buffer mode gathers first, as the reference's does
    monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", "full")
    full = da.decode_attention(_t(q), _t(k), _t(v), torch.tensor(pos), scale,
                               page_table=torch.tensor(ptab))
    jfull = jda.decode_attention(*args, scale, page_table=jnp.asarray(ptab))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_plain_equals_dense_over_view_and_ignores_garbage(quant):
    q, k, v, ptab, pos, unowned = _pool_case(quant, 3, seed=5)
    scale = 0.25
    qt, pt, pst = _t(q), torch.tensor(ptab), torch.tensor(pos)
    got = da.decode_attention(qt, _t(k), _t(v), pst, scale, page_table=pt)
    dense = da.bounded_decode_attention(
        qt, da.paged_view(_t(k), pt), da.paged_view(_t(v), pt), pst.long(),
        scale, PS)
    assert torch.equal(got, dense)
    # garbage in the scratch page and in pages no row owns changes nothing
    kg, vg = _t(k), _t(v)
    dead = torch.tensor([0] + list(unowned))
    for leaf, fill in ((kg, 1e4), (vg, -1e4)):
        if quant:
            leaf[0][dead] = 127 if fill > 0 else -127
            leaf[1][dead] = 1e4
        else:
            leaf[dead] = fill
    out = da.decode_attention(qt, kg, vg, pst, scale, page_table=pt)
    assert torch.equal(out, got)


def test_paged_wrappers_run_no_kernel_on_cpu_and_raise_elsewhere():
    q, k, v, ptab, pos, _ = _pool_case(False, 1)
    before = (da.decode_attention_paged.launches,
              da.decode_attention_paged_q8.launches)
    da.decode_attention_paged(_t(q), _t(k), _t(v), torch.tensor(pos),
                              torch.tensor(ptab))
    q8 = _pool_case(True, 1)
    da.decode_attention_paged_q8(_t(q8[0]), _t(q8[1]), _t(q8[2]),
                                 torch.tensor(q8[4]), torch.tensor(q8[3]))
    assert (da.decode_attention_paged.launches,
            da.decode_attention_paged_q8.launches) == before
    meta = lambda a: torch.zeros(a.shape, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        da.decode_attention_paged(meta(q), meta(k), meta(v),
                                  torch.zeros(3, device="meta"),
                                  torch.tensor(ptab))
    with pytest.raises(ValueError, match="no kernel"):
        da.decode_attention_paged_q8(
            meta(q), tuple(map(meta, q8[1])), tuple(map(meta, q8[2])),
            torch.zeros(3, device="meta"), torch.tensor(ptab))
    with pytest.raises(ValueError, match="pools"):
        da._check_inputs(_t(q), _t(k)[:, :1], _t(v)[:, :1],
                         torch.tensor(pos), paged=True)
    with pytest.raises(ValueError, match="page_table"):
        da._table(torch.zeros((2, 4)), _t(q))


# ================================================================ helpers
def _scatter_case(seed=3, B=3, H=2, d=16, nb=4, P=14, n=5):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((P, H, PS, d)).astype(np.float32)
    vals = rng.standard_normal((B, H, n, d)).astype(np.float32)
    ptab = np.zeros((B, nb), np.int32)
    ptab[:, :3] = rng.permutation(np.arange(1, P))[:9].reshape(B, 3)
    pos = np.asarray([3, 10, 17])          # windows cross page edges
    return pool, vals, ptab, pos


@pytest.mark.parametrize("valid_rank", [0, 1, 2])
def test_page_scatter_and_write_match_reference(valid_rank):
    pool, vals, ptab, pos = _scatter_case()
    valid = (None, np.asarray([True, False, True]),
             np.asarray([[1, 1, 0, 1, 1], [1, 0, 1, 1, 1],
                         [0, 1, 1, 1, 0]], bool))[valid_rank]
    tv = None if valid is None else torch.tensor(valid)
    jv = None if valid is None else jnp.asarray(valid)
    # masked writes all land on the scratch page 0, several at one offset,
    # where which of them wins is unspecified: compare the real pages
    got = torch.tensor(pool)
    tg._page_scatter(got, torch.tensor(vals), torch.tensor(pos),
                     torch.tensor(ptab, dtype=torch.int32), tv)
    ref = jg._page_scatter(jnp.asarray(pool), jnp.asarray(vals),
                           jnp.asarray(pos, jnp.int32), jnp.asarray(ptab),
                           jv)
    np.testing.assert_array_equal(got[1:].numpy(), np.asarray(ref)[1:])
    # the scaled-int8 pair: codes and steps through the same scatter
    pair = (torch.zeros(pool.shape, dtype=torch.int8),
            torch.zeros(pool.shape[:3]))
    tg.paged_write(pair, torch.tensor(vals), torch.tensor(pos),
                   torch.tensor(ptab), tv)
    jpair = jg.paged_write(
        (jnp.zeros(pool.shape, jnp.int8), jnp.zeros(pool.shape[:3])),
        jnp.asarray(vals), jnp.asarray(pos, jnp.int32), jnp.asarray(ptab),
        jv)
    np.testing.assert_array_equal(pair[0][1:].numpy(),
                                  np.asarray(jpair[0])[1:])
    np.testing.assert_array_equal(pair[1][1:].numpy(),
                                  np.asarray(jpair[1])[1:])


def test_paged_gather_matches_reference():
    pool, _, ptab, _ = _scatter_case()
    codes, steps = quantize_rows(torch.tensor(pool))
    for leaf in (pool, (codes.numpy(), steps.numpy())):
        got = tg.paged_gather(_t(leaf), torch.tensor(ptab))
        ref = jg.paged_gather(_j(leaf), jnp.asarray(ptab))
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# =========================================================== prefix cache
def test_chain_keys_of_int64_prompt_match_reference():
    tokens = np.random.default_rng(4).integers(0, 50304, (37,))
    assert tokens.dtype == np.int64
    assert tpc.chain_keys(tokens, 8) == jpc.chain_keys(
        tokens.astype(np.int32), 8)
    assert tpc.chain_keys(tokens, 5, 3) == jpc.chain_keys(tokens, 5, 3)


def test_prefix_cache_decisions_match_reference():
    """A seeded sequence of inserts, matches, peeks and LRU evictions over
    prompts that share prefixes: the same hits, chains, promotions,
    releases and stats as the reference's pool."""
    rng = np.random.default_rng(11)
    heads = [rng.integers(0, VOCAB, (int(n),)) for n in (8, 12, 4)]
    prompts = [np.concatenate([heads[rng.integers(3)],
                               rng.integers(0, VOCAB, (int(t),))])
               for t in rng.integers(0, 9, 24)]
    logs = []
    for mod, span in ((tpc, PageSpan), (jpc, jpc.PageSpan)):
        released, log = [], []
        pool = mod.PrefixCache(block=4, max_blocks=5, promote_after=2,
                               on_release=lambda e: released.append(
                                   e[0].pages))
        reads = iter(range(10 ** 6))

        def read_span(start, length):
            base = 1000 * next(reads) + start // 4
            pages = list(range(base, base + length // 4))
            return span(pages, 4), span(pages, 4)

        for i, p in enumerate(prompts):
            op = i % 3
            if op == 0:
                log.append(("insert", pool.insert(p, read_span)))
            elif op == 1:
                n, blocks = pool.match(p, max_prefix=len(p) - 1)
                log.append(("match", n, [b[0].pages for b in blocks]))
            else:
                n, keys, blocks = pool.peek(p)
                log.append(("peek", n, keys, [b[0].pages for b in blocks]))
        log.append(("released", released, pool.stats(), len(pool)))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][-1][2]["hits"] > 0 and logs[0][-1][2]["evictions"] > 0


def test_span_helpers():
    sp = PageSpan([3, 5, 9], 8)
    assert tpc.span_tokens(sp) == 24
    assert tpc.span_slice(sp, 8, 16).pages == [5, 9]
    assert tpc.span_concat([PageSpan([1], 8),
                            PageSpan([2, 4], 8)]).pages == [1, 2, 4]
    with pytest.raises(ValueError):
        tpc.span_slice(sp, 3, 8)
    with pytest.raises(TypeError):
        tpc.span_concat([PageSpan([1], 8), torch.zeros((1, 1, 8, 1))])
    a, b = torch.zeros((2, 3, 8, 4)), torch.ones((2, 3, 4, 4))
    cat = tpc.span_concat([(a, a[..., 0]), (b, b[..., 0])])
    assert cat[0].shape == (2, 3, 12, 4) and cat[1].shape == (2, 3, 12)
    assert tpc.span_tokens(cat) == 12


# ================================================================ session
@pytest.fixture(scope="module")
def weights():
    """Reference init at gpt_tiny(n_layers=2) with the matrices and the
    position table scaled up, so greedy streams vary token to token."""
    jcfg = dataclasses.replace(jg.gpt_tiny(), n_layers=2, decode_block=PS)
    tree = jax.device_get(jg.init_params(jcfg, 7))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * 8.0
    tree["wte"] = tree["wte"] * 8.0
    tree["wpe"] = tree["wpe"] * 30.0
    tcfg = tg.gpt_tiny(n_layers=2, decode_block=PS)
    return jcfg, tree, tcfg, tg.params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def w8kv8(weights):
    qcfg = tg.gpt_tiny(n_layers=2, decode_block=PS, weight_quant="int8",
                       kv_cache_dtype="int8")
    return qcfg, quantize_gpt_params(weights[3], qcfg, bits=8)


def _session(model, paged, kv_pages=None, **kw):
    cfg, params = model
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_prompt_len", 32)
    kw.setdefault("max_len", 40)
    return GenerationSession(params, cfg, kv_paged=paged,
                             kv_pages=kv_pages if paged else None,
                             device="cpu", **kw)


def _fp(weights):
    return weights[2], weights[3]


def _free_all(sess):
    t, f, _ = sess.kv_page_stats()
    assert f == t


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "w8kv8"])
def test_paged_generate_streams_equal_dense(weights, w8kv8, quant):
    model = w8kv8 if quant else _fp(weights)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, VOCAB, (3, 12))
    lens = np.asarray([12, 7, 10])
    outs = []
    for paged in (False, True):
        s = _session(model, paged, max_prompt_len=16)
        outs.append(s.generate(prompts, lens, max_new_tokens=12))
        m = s.metrics()
        if paged:
            _free_all(s)
            assert m["kv_page_size"] == PS and m["kv_pages_total"] == 20
            assert m["kv_pages_shared"] == 0
        else:
            assert "kv_pages_total" not in m
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "w8kv8"])
def test_chunked_and_fused_streams_equal_dense(weights, w8kv8, quant):
    model = w8kv8 if quant else _fp(weights)
    rng = np.random.default_rng(9)
    pa, pb = rng.integers(1, VOCAB, (12,)), rng.integers(1, VOCAB, (10,))
    outs = []
    for paged in (False, True):
        s = _session(model, paged, max_prompt_len=16)
        sa = s.admit(pa[None, :])[0]
        sb = s.alloc_slot(need_tokens=22) if paged else s.alloc_slot()
        emitted = {sa: [], sb: []}
        for chunk, off, fin in ((pb[:8], 0, False), (pb[8:10], 8, True)):
            for k, t in s.fused_tick([(sb, chunk, off, fin)], 8).items():
                emitted[k].append(t)
        for _ in range(8):
            for k, t in s.step().items():
                emitted[k].append(t)
        outs.append((emitted[sa], emitted[sb]))
        s.evict(sa)
        s.evict(sb)
        if paged:
            _free_all(s)
    assert outs[0] == outs[1]


def test_need_sized_grant_rounds_to_pages(weights):
    s = _session(_fp(weights), True)
    slot = s.alloc_slot(need_tokens=10)
    assert len(s._row_pages[slot]) == 2 and s.kv_row_pages_total() == 2
    assert list(s._ptab[slot, 2:]) == [0, 0, 0]     # scratch past the grant
    s.release_slot(slot)
    slot = s.alloc_slot()
    assert len(s._row_pages[slot]) == s._pages_per_row == 5
    s.release_slot(slot)
    _free_all(s)
    assert s.kv_bytes_per_token() == 2 * 2 * 64 * 4   # K+V, 2 layers, f32
    with pytest.raises(ValueError, match="kv_pages"):
        _session(_fp(weights), True, kv_pages=5)
    with pytest.raises(ValueError, match="paged"):
        GenerationSession(weights[3], weights[2], 2, kv_pages=9,
                          device="cpu")


def test_try_admit_none_on_page_exhaustion_and_admit_names_pages(weights):
    # 5 pages a row, 6 grantable: one full-row admission fits, not two
    s = _session(_fp(weights), True, kv_pages=7, max_prompt_len=16)
    p = np.random.default_rng(1).integers(1, VOCAB, (1, 8))
    slots = s.try_admit(p)
    assert slots is not None
    assert s.try_admit(p) is None
    assert s.metrics()["requests_rejected"] == 0
    with pytest.raises(ValueError, match=r"KV pages.*free"):
        s.admit(p)
    assert s.metrics()["requests_rejected"] == 1
    s.evict(slots[0])
    assert s.try_admit(p) is not None


def test_alloc_slot_backpressures_on_pages(weights):
    s = _session(_fp(weights), True, kv_pages=7)
    a = s.alloc_slot(need_tokens=40)      # 5 pages
    assert a is not None
    assert s.alloc_slot(need_tokens=40) is None    # 1 page left
    b = s.alloc_slot(need_tokens=8)
    assert b is not None
    s.release_slot(a)
    s.release_slot(b)
    _free_all(s)


def test_page_freed_only_at_zero_readers(weights):
    """Pool and row both hold a page (2 readers): pool eviction leaves it
    to the row, and only the row's eviction frees it."""
    rng = np.random.default_rng(13)
    shared = rng.integers(1, VOCAB, (8,))
    s = _session(_fp(weights), True)
    pool = PrefixCache(block=8, max_blocks=4, promote_after=1,
                       on_release=s.release_pooled_entry)
    p0 = np.concatenate([shared, rng.integers(1, VOCAB, (4,))])
    slot = s.alloc_slot(need_tokens=len(p0) + 4)
    s.prefill_chunks([(slot, p0, 0, True)], width=16)
    pool.insert(p0, lambda st, ln: s.read_prefix_block(slot, st, ln))
    s.evict(slot)
    assert len(pool) == 1

    p1 = np.concatenate([shared, rng.integers(1, VOCAB, (5,))])
    n, blocks = pool.match(p1, max_prefix=len(p1) - 1)
    assert n == 8 and isinstance(blocks[0][0], PageSpan)
    pid = blocks[0][0].pages[0]
    slot = s.alloc_slot(need_tokens=len(p1) + 4)
    assert s.copy_prefix_into(slot, blocks) == n
    assert s._page_ref[pid] == 2 and s.kv_page_stats()[2] == 1
    while len(pool):                      # evict under a live alias
        pool._evict_one()
    assert s._page_ref[pid] == 1 and pid not in s._free_pg
    s.prefill_chunks([(slot, p1[n:], n, True)], width=8)
    s.step()
    s.evict(slot)                         # the last reader goes
    assert s._page_ref[pid] == 0 and pid in s._free_pg
    _free_all(s)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "w8kv8"])
def test_evict_under_sharing_keeps_chain_intact(weights, w8kv8, quant):
    """Row A promotes a shared prefix, row B aliases it, A is evicted
    while B decodes: B's stream equals a dense run's."""
    model = w8kv8 if quant else _fp(weights)
    rng = np.random.default_rng(17)
    shared = rng.integers(1, VOCAB, (16,))
    tails = [rng.integers(1, VOCAB, (6,)) for _ in range(2)]
    results = []
    for paged in (False, True):
        s = _session(model, paged)
        pool = PrefixCache(block=8, max_blocks=8, promote_after=1,
                           on_release=s.release_pooled_entry)
        pa = np.concatenate([shared, tails[0]])
        sa = s.alloc_slot(need_tokens=len(pa) + 8)
        s.prefill_chunks([(sa, pa, 0, True)], width=24)
        pool.insert(pa, lambda st, ln: s.read_prefix_block(sa, st, ln))
        pb = np.concatenate([shared, tails[1]])
        n, blocks = pool.match(pb, max_prefix=len(pb) - 1)
        assert n == 16
        sb = s.alloc_slot(need_tokens=len(pb) + 8)
        off = s.copy_prefix_into(sb, blocks)
        s.prefill_chunks([(sb, pb[off:], off, True)], width=24)
        s.evict(sa)                       # the promoter dies first
        results.append([s.step()[sb] for _ in range(8)])
        s.evict(sb)
        if paged:
            while len(pool):
                pool._evict_one()
            _free_all(s)
    assert results[0] == results[1]


def test_array_prefix_copies_into_granted_pages(weights):
    """A dense session's prefix span (arrays) lands in a paged row's own
    pages and serves the stream a full prefill gives."""
    rng = np.random.default_rng(19)
    prompt = rng.integers(1, VOCAB, (21,))
    dense = _session(_fp(weights), False)
    src = dense.alloc_slot()
    dense.prefill_chunks([(src, prompt, 0, True)], width=24)
    want = [dense.step()[src] for _ in range(6)]
    blocks = [dense.read_prefix_block(src, 0, 8),
              dense.read_prefix_block(src, 8, 8)]
    s = _session(_fp(weights), True)
    slot = s.alloc_slot(need_tokens=len(prompt) + 6)
    assert s.copy_prefix_into(slot, blocks) == 16
    assert s.kv_page_stats()[2] == 0      # copied, not shared
    s.prefill_chunks([(slot, prompt[16:], 16, True)], width=8)
    assert [s.step()[slot] for _ in range(6)] == want
    with pytest.raises(ValueError, match="page-aligned"):
        s.read_prefix_block(slot, 4, 8)
    # span export and import (the fleet's handoff): a paged export
    # materializes the row's pages, equal to the bytes copied in, and
    # moves no refcount; a by-reference span materializes alike; an
    # import lands like a prefix copy and serves the same stream
    stats = s.kv_page_stats()
    k, v = s.export_kv_span(slot, 16)
    assert s.kv_page_stats() == stats
    assert torch.equal(k, torch.cat([b[0] for b in blocks], 2))
    assert torch.equal(v, torch.cat([b[1] for b in blocks], 2))
    pk, pv = s.read_prefix_block(slot, 0, 16)
    mk, mv = s.materialize_span(pk, pv)
    assert torch.equal(mk, k) and torch.equal(mv, v)
    assert s.materialize_span(k, v) == (k, v)
    s.release_pooled_entry((pk, pv))
    assert s.kv_page_stats() == stats
    with pytest.raises(ValueError, match="page-aligned"):
        s.export_kv_span(slot, 12)
    dst = s.alloc_slot(need_tokens=len(prompt) + 6)
    assert s.import_kv_span(dst, k, v) == 16
    s.prefill_chunks([(dst, prompt[16:], 16, True)], width=8)
    assert [s.step()[dst] for _ in range(6)] == want


# ================================================================= engine
def _engine_trace():
    rng = np.random.default_rng(21)
    shared = rng.integers(1, VOCAB, (16,)).astype(np.int32)
    trace = []
    for i in range(8):
        if i % 2 == 0:
            p = np.concatenate([shared, rng.integers(1, VOCAB, (4 + i,))])
        else:
            p = rng.integers(1, VOCAB, (10 + i,))
        trace.append((p.astype(np.int32), 6 + i % 3))
    return trace


def _drive(eng, sess, trace):
    """Run the trace poll by poll; returns the per-request streams and
    prefix hits, after every poll the page counters (total, free, shared),
    the pages held by rows, the free slots and the queue depth, and the
    engine's metrics."""
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in trace]
    pages = []
    while eng.pending:
        eng.poll()
        pages.append((tuple(int(x) for x in sess.kv_page_stats()),
                      int(sess.kv_row_pages_total()),
                      len(sess.free_slots()), eng._queued))
        assert len(pages) < 4000
    assert all(r.state.value == "done" for r in reqs)
    return ([list(map(int, r.output)) for r in reqs],
            [int(r.prefix_hit_tokens) for r in reqs], pages, eng.metrics())


ENGINE_CASES = {"reuse": dict(kv_pages=None, blocks=16),
                "constrained": dict(kv_pages=13, blocks=0)}


@pytest.fixture(scope="module")
def reference_engine_runs(weights):
    """The reference's paged engine on the trace, once per case."""
    jcfg, tree, _, _ = weights
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    runs = {}
    for name, case in ENGINE_CASES.items():
        sess = JSession(jp, jcfg, max_slots=4, max_prompt_len=32, max_len=40,
                        kv_paged=True, kv_pages=case["kv_pages"])
        eng = JEngine(sess, max_queue=64, prefill_chunk=8,
                      prefix_cache_blocks=case["blocks"])
        runs[name] = _drive(eng, sess, _engine_trace())
        eng.close()
    return runs


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_paged_engine_matches_reference_engine(weights,
                                               reference_engine_runs, case):
    kw = ENGINE_CASES[case]
    sess = _session(_fp(weights), True, kv_pages=kw["kv_pages"])
    eng = ServingEngine(sess, max_queue=64, prefill_chunk=8,
                        prefix_cache_blocks=kw["blocks"], device="cpu")
    outs, hits, pages, met = _drive(eng, sess, _engine_trace())
    r_outs, r_hits, r_pages, r_met = reference_engine_runs[case]
    assert outs == r_outs
    assert hits == r_hits
    assert pages == r_pages
    for key in ("kv_pages_total", "kv_pages_free", "kv_pages_shared",
                "kv_page_size"):
        assert met[key] == r_met[key]
    if kw["blocks"]:
        assert met["prefix_cache"] == r_met["prefix_cache"]
        assert sum(hits) > 0
    else:
        # requests waited in the queue while a slot was free: pages, not
        # slots, held them back
        assert any(free_slots and queued
                   for _, _, free_slots, queued in pages)
    eng.close()
    # the same streams as the dense engine with reuse
    d_eng = ServingEngine(_session(_fp(weights), False), max_queue=64,
                          prefill_chunk=8, prefix_cache_blocks=16,
                          device="cpu")
    reqs = [d_eng.submit(p, max_new_tokens=m) for p, m in _engine_trace()]
    d_eng.run()
    assert [list(map(int, r.output)) for r in reqs] == outs
    assert all(r.state is RequestState.DONE for r in eng.requests)

"""The split-K design of the decode-attention kernels, on the CPU.

The CUDA kernel (csrc/decode_attention.cu, split_decode_kernel; bf16/f32
caches and scaled-int8 (codes, steps) pairs, dense and paged) gives each
(b, h) a cluster of ``nsplit`` blocks; rank r runs an online softmax over
keys ``[r * chunk, (r + 1) * chunk)`` cut at the row's live length, and the
ranks' states merge in rank order. Here: the split function's contract
(:func:`decode_split`), a torch emulation of that partition and merge
against the JAX reference (the XLA bounded loop and the Pallas kernel in
interpret mode), the paged emulation against the dense one over the
gathered view (bitwise, as the card's paged kernel is held to its dense
kernel), and the arguments the wrappers hand the C entries."""
import importlib
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.kernels import decode_attention as da

jda = importlib.import_module("paddle_tpu.ops.pallas.decode_attention")
jprim = importlib.import_module("paddle_tpu.ops.pallas.primitives")

torch.set_num_threads(1)

F32_TOL = 1e-5
NEG = -1e30
# keys a group of the emulation's loop (a warp's group at D = 128 int8)
GROUP = 8


def _interpret(fn, *args, **kw):
    """Run a Pallas kernel in interpret mode as the reference's own tests
    do, restoring the flag afterwards."""
    old = jprim.interpret()
    jprim.set_interpret(True)
    try:
        return fn(*args, **kw)
    finally:
        jprim.set_interpret(old)


def _key_rows(cache, b, keys, ptab):
    """Rows ``keys`` of batch row b as [H, n, d]: a dense cache's, or a
    pool's through the table (an entry outside the pool reads page 0, as
    the kernel's loads do)."""
    if ptab is None:
        return cache[b][:, keys]
    ps = cache.shape[2]
    pages = ptab[b][keys // ps].long()
    pages = torch.where((pages >= 0) & (pages < cache.shape[0]), pages, 0)
    return cache[pages, :, keys % ps].transpose(0, 1)


def _rows_f32(cache, b, keys, ptab):
    """:func:`_key_rows` in f32, and for a scaled-int8 ``(codes, steps)``
    pair the keys' steps [H, n], read through the same row as the codes
    (None for a bf16/f32 cache)."""
    data, steps = da._kv_parts(cache)
    rows = _key_rows(data, b, keys, ptab).float()
    return rows, None if steps is None else _key_rows(steps, b, keys, ptab)


def split_emulation(q, k, v, pos, scale, split, ptab=None):
    """The kernel's partition and merge in torch f32: for each (b, h),
    rank r walks keys [r * chunk, min((r + 1) * chunk, pos + Q, S)) in
    groups of GROUP keys with an online softmax whose masked keys add
    exactly 0 (a rank with no live key keeps m = -1e30, l = 0, acc = 0),
    then the ranks' states merge in rank order. k and v are bf16/f32
    caches or scaled-int8 pairs, in the kernel's order: each step factored
    out of its codes, a score ``(q . codes) * k_step * scale`` and a weight
    ``p * v_step`` on the value's codes."""
    nsplit, chunk = split
    B, H, Q, d = q.shape
    kd = da._kv_parts(k)[0]
    S = kd.shape[2] if ptab is None else ptab.shape[1] * kd.shape[2]
    qf = q.float()
    out = torch.empty((B, H, Q, d), dtype=torch.float32)
    rows_q = torch.arange(Q)
    for b in range(B):
        p0 = int(pos[b])
        row_end = min(p0 + Q, S)
        states = []
        for r in range(nsplit):
            m = torch.full((H, Q, 1), NEG)
            l = torch.zeros((H, Q, 1))
            acc = torch.zeros((H, Q, d))
            end = min(r * chunk + chunk, row_end)
            for g in range(r * chunk, end, GROUP):
                keys = torch.arange(g, min(g + GROUP, end))
                kb, ks = _rows_f32(k, b, keys, ptab)
                vb, vs = _rows_f32(v, b, keys, ptab)
                s = torch.matmul(qf[b], kb.transpose(-1, -2))
                if ks is not None:
                    s = s * ks[:, None, :]
                s = s * scale
                live = keys[None, None, :] <= (p0 + rows_q)[None, :, None]
                s = torch.where(live, s, torch.full_like(s, NEG))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.where(live, torch.exp(s - m_new),
                                torch.zeros_like(s))
                l = l * alpha + p.sum(-1, keepdim=True)
                w = p if vs is None else p * vs[:, None, :]
                acc = acc * alpha + torch.matmul(w, vb)
                m = m_new
            states.append((m, l, acc))
        mt = states[0][0]
        for m, _, _ in states[1:]:
            mt = torch.maximum(mt, m)
        lt = torch.zeros((H, Q, 1))
        at = torch.zeros((H, Q, d))
        for m, l, acc in states:
            f = torch.exp(m - mt)
            lt = lt + l * f
            at = at + acc * f
        out[b] = at / torch.where(lt == 0, torch.ones_like(lt), lt)
    return out


# ------------------------------------------------------- the split function
def test_decode_split_is_a_function_of_the_shape_alone():
    assert list(inspect.signature(da.decode_split).parameters) == \
        ["B", "H", "S", "Q"]


@pytest.mark.parametrize("B,H,S", [
    (8, 16, 512), (4, 16, 384), (8, 16, 2048), (2, 16, 200), (3, 4, 64),
    (3, 2, 200), (1, 1, 1), (1, 2, 31), (1, 2, 33), (64, 16, 4096),
    (33, 16, 1000), (4, 16, 8192), (1, 16, 100000)])
@pytest.mark.parametrize("Q", [1, 3, 8])
def test_decode_split_stays_within_its_bounds(B, H, S, Q):
    nsplit, chunk = da.decode_split(B, H, S, Q)
    assert 1 <= nsplit <= da.DECODE_MAX_SPLIT
    assert chunk >= da.DECODE_CHUNK_KEYS and chunk % da.DECODE_CHUNK_KEYS == 0
    # the ranks cover the keys, and none lies wholly past S
    assert nsplit * chunk >= S > (nsplit - 1) * chunk
    # the grid stays resident, and a split rank keeps a whole chunk
    resident = da.decode_blocks_per_sm(Q) * da.DECODE_SMS
    assert B * H * nsplit <= max(B * H, resident)
    assert nsplit == 1 or chunk >= da.DECODE_MIN_CHUNK


@pytest.mark.parametrize("B,H,S", [(8, 16, 512), (4, 16, 384)])
def test_decode_split_fills_the_card_at_the_main_shapes(B, H, S):
    """The engine's 8 slots x 512 positions and generate()'s B = 4 with its
    cache padded to 384: at least two blocks for each of the 132 SMs."""
    nsplit, chunk = da.decode_split(B, H, S, 1)
    assert B * H * nsplit >= 2 * 132
    assert (nsplit, chunk) == {512: (6, 96), 384: (6, 64)}[S]


def test_decode_split_gives_a_wider_window_fewer_ranks():
    """A window of up to 4 rows runs an instance of half the blocks an SM
    (3 instead of 6): the engine's 8 x 16 rows get 3 ranks, not 6."""
    assert da.decode_split(8, 16, 2048, 1) == (6, 352)
    assert da.decode_split(8, 16, 2048, 4) == (3, 704)
    assert da.decode_split(8, 16, 2048, 8) == (2, 1024)


def test_decode_split_q8_is_a_function_of_the_shape_alone():
    assert list(inspect.signature(da.decode_split_q8).parameters) == \
        ["B", "H", "S", "Q"]


@pytest.mark.parametrize("B,H,S", [
    (8, 16, 512), (4, 16, 384), (8, 16, 2048), (2, 16, 200), (3, 4, 64),
    (3, 2, 200), (1, 1, 1), (1, 2, 31), (1, 2, 33), (64, 16, 4096),
    (33, 16, 1000), (4, 16, 8192), (1, 16, 100000)])
@pytest.mark.parametrize("Q", [1, 3, 8])
def test_decode_split_q8_stays_within_its_bounds(B, H, S, Q):
    nsplit, chunk = da.decode_split_q8(B, H, S, Q)
    assert 1 <= nsplit <= da.DECODE_MAX_SPLIT
    assert chunk >= da.DECODE_CHUNK_KEYS and chunk % da.DECODE_CHUNK_KEYS == 0
    assert nsplit * chunk >= S > (nsplit - 1) * chunk
    # the grid stays within the int8 table's blocks an SM, which the
    # kernel's launch bounds (five at Q = 1) hold resident
    resident = da.decode_blocks_per_sm_q8(Q) * da.DECODE_SMS
    assert B * H * nsplit <= max(B * H, resident)
    assert da.decode_blocks_per_sm_q8(Q) <= da.decode_blocks_per_sm(Q)
    assert nsplit == 1 or chunk >= da.DECODE_MIN_CHUNK


def test_decode_split_q8_at_the_scanned_shapes():
    """The splits the scan on the card found fastest for the int8 forms:
    at the engine's 8 x 16 rows over 512 positions 4 ranks of one 128-key
    page each (6 ranks of 96 in bf16), 4 over 2048, 6 at generate()'s
    4 x 16 over 384; wider windows as bf16."""
    assert da.decode_split_q8(8, 16, 512, 1) == (4, 128)
    assert da.decode_split_q8(8, 16, 2048, 1) == (4, 512)
    assert da.decode_split_q8(4, 16, 384, 1) == (6, 64)
    for S in (512, 2048):
        for Q in (2, 4, 8):
            assert da.decode_split_q8(8, 16, S, Q) == \
                da.decode_split(8, 16, S, Q)


@pytest.mark.parametrize("S", [1, 31, 32, 33, 200, 384, 512, 2048])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_split_keys_covers_the_range(S, n):
    nsplit, chunk = da.split_keys(S, n)
    assert nsplit <= n and chunk % da.DECODE_CHUNK_KEYS == 0
    assert nsplit * chunk >= S > (nsplit - 1) * chunk


def _record_launch(monkeypatch):
    """Replace the C entries by a recorder: [(name, args)]."""
    calls = []

    def lib(name="decode_attention"):
        def entry(*args):
            calls.append((name, args))
            return 0
        return entry

    monkeypatch.setattr(da, "_lib", lib)
    monkeypatch.setattr(da, "_stream", lambda q: 0)
    return calls


@pytest.mark.parametrize("ps,nb", [(8, 8), (16, 4), (128, 4), (128, 16)])
def test_dense_call_over_the_view_splits_as_the_paged_call(monkeypatch, ps,
                                                           nb):
    """What the wrappers hand the C entries: a dense launch over the
    gathered view (S = nb * ps) and the paged launch get the same (nsplit,
    chunk), and each entry gets as many arguments as its argument types
    name (+ scale and stream)."""
    calls = _record_launch(monkeypatch)
    B, H, Q, d = 3, 16, 1, 128
    P = 1 + B * nb
    q = torch.zeros((B, H, Q, d), dtype=torch.bfloat16)
    pool = torch.zeros((P, H, ps, d), dtype=torch.bfloat16)
    ptab = torch.arange(1, P, dtype=torch.int32).reshape(B, nb)
    view = da.paged_view(pool, ptab).contiguous()
    pos = torch.tensor([0, 9, nb * ps - 1])
    out = torch.empty((B, H, Q, d))
    da._launch(q, view, view, pos, out, 0.1)
    da._launch(q, pool, pool, pos, out, 0.1, ptab=ptab)
    (dn, dargs), (pn, pargs) = calls
    assert (dn, pn) == ("decode_attention", "decode_attention_paged")
    for name, args in calls:
        assert len(args) == len(da._ARGTYPES[name]) + 2
    split = da.decode_split(B, H, nb * ps, Q)
    assert dargs[-4:-2] == pargs[-4:-2] == split
    # bf16 q and int64 pos go to the kernel as they are, with their strides
    assert dargs[:5] == (q.data_ptr(), 1, *q.stride()[:3])
    assert dargs[7:10] == (pos.data_ptr(), 1, 1)


def test_launch_reads_q_and_pos_through_their_strides(monkeypatch):
    """The model's q is a strided view of the fused qkv product and a
    scalar position is expanded over the batch: neither is copied."""
    calls = _record_launch(monkeypatch)
    B, H, Q, d = 2, 4, 1, 16
    qkv = torch.zeros((B, Q, H, 3, d), dtype=torch.bfloat16)
    q = qkv[:, :, :, 0].transpose(1, 2)
    pos = torch.tensor(5).expand(B)
    k = torch.zeros((B, H, 64, d), dtype=torch.bfloat16)
    da._launch(q, k, k, pos, torch.empty((B, H, Q, d)), 0.25)
    _, args = calls[0]
    assert args[:5] == (q.data_ptr(), 1, *q.stride()[:3])
    assert args[7:10] == (pos.data_ptr(), 1, 0)
    # f32 q is read as f32; an f16 q and int16 positions are cast first
    da._launch(q.float(), k, k, pos.int(), torch.empty((B, H, Q, d)), 0.25)
    assert calls[1][1][1] == 0 and calls[1][1][8] == 0
    da._launch(q.half(), k, k, pos.short(), torch.empty((B, H, Q, d)), 0.25)
    assert calls[2][1][1] == 0 and calls[2][1][2:4] == (H * Q * d, Q * d)


# ------------------------------------------- the emulation vs the reference
def _inputs(seed, B, H, S, d, Q, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Q, d)).astype(np.float32)
    k = rng.standard_normal((B, H, S, d)).astype(np.float32)
    v = rng.standard_normal((B, H, S, d)).astype(np.float32)
    tk = torch.from_numpy(k).to(dtype)
    tv = torch.from_numpy(v).to(dtype)
    # the reference sees the same (bf16-rounded) cache values
    return q, tk.float().numpy(), tv.float().numpy(), tk, tv


@pytest.mark.parametrize("split", [None, (1, 224), (2, 128), (7, 32)])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("Q", [1, 3])
def test_split_emulation_matches_the_reference(Q, d, split):
    """S = 200 is no multiple of any chunk; row 0 at pos 0 leaves every
    rank but the first with no live key, row 1 some ranks."""
    B, H, S = 3, 2, 200
    q, k, v, tk, tv = _inputs(Q * 10 + d, B, H, S, d, Q, torch.bfloat16)
    pos = np.asarray([0, 97, S - Q], np.int32)
    scale = d ** -0.5
    split = split or da.decode_split(B, H, S, Q)
    nsplit, chunk = split
    assert nsplit * chunk >= S and S % chunk
    got = split_emulation(torch.from_numpy(q), tk, tv, torch.from_numpy(pos),
                          scale, split).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(pos), scale, 40)
    bounded = np.asarray(jda._xla_bounded_decode_attention(*jargs))
    kernel = np.asarray(_interpret(jda._pallas_decode_attention, *jargs))
    for ref in (bounded, kernel):
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)


def test_split_emulation_matches_the_port_plain_version():
    """The f32 cache at the split the engine's shape gets (6 ranks of 96
    keys), against the port's own plain bounded loop."""
    B, H, S, d, Q = 8, 2, 512, 32, 1
    q, _, _, tk, tv = _inputs(5, B, H, S, d, Q, torch.float32)
    pos = torch.tensor([round(511 * i / 7) for i in range(8)])
    split = da.decode_split(B, 16, S, Q)
    assert split == (6, 96)
    tq = torch.from_numpy(q)
    got = split_emulation(tq, tk, tv, pos, 0.2, split)
    ref = da.bounded_decode_attention(tq, tk, tv, pos, 0.2, 128)
    torch.testing.assert_close(got, ref, atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------ paged against the view
@pytest.mark.parametrize("ps", [8, 16, 128])
@pytest.mark.parametrize("Q", [1, 3])
def test_paged_emulation_equals_the_view_bitwise(ps, Q):
    """The pool read through a shuffled table whose entries past each
    row's live pages name the scratch page 0 (filled with garbage), against
    the gathered dense view: the same float operations, the same bits."""
    B, H, d = 3, 2, 16
    nb = 256 // ps
    S = nb * ps
    P = 1 + B * nb
    rng = np.random.default_rng(ps + Q)
    q = torch.from_numpy(rng.standard_normal((B, H, Q, d)).astype(np.float32))
    pool_k = torch.from_numpy(
        rng.standard_normal((P, H, ps, d)).astype(np.float32)).bfloat16()
    pool_v = torch.from_numpy(
        rng.standard_normal((P, H, ps, d)).astype(np.float32)).bfloat16()
    pool_k[0], pool_v[0] = 1e4, -1e4
    pos = torch.tensor([0, 70, S - Q])
    ptab = torch.from_numpy(rng.permutation(P - 1) + 1)[:B * nb].reshape(
        B, nb).int()
    live_pages = (pos + Q + ps - 1) // ps
    ptab = torch.where(torch.arange(nb)[None] >= live_pages[:, None],
                       torch.zeros_like(ptab), ptab)
    assert int((ptab == 0).sum()) > 0
    split = da.decode_split(B, H, S, Q)
    assert split[0] > 1
    paged = split_emulation(q, pool_k, pool_v, pos, 0.25, split, ptab=ptab)
    dense = split_emulation(q, da.paged_view(pool_k, ptab),
                            da.paged_view(pool_v, ptab), pos, 0.25, split)
    assert torch.equal(paged, dense)
    ref = da.bounded_decode_attention(q, pool_k, pool_v, pos, 0.25, ps,
                                      ptab=ptab)
    torch.testing.assert_close(paged, ref, atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------ the scaled-int8 forms
def _q8_pair(rng, shape):
    """A seeded (codes int8 [..., d], steps f32 [...]) pair: codes over the
    whole int8 range, steps of an absmax step of N(0, 1) rows."""
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    steps = rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32)
    return codes, steps


def _t_pair(pair):
    return tuple(torch.from_numpy(a) for a in pair)


@pytest.mark.parametrize("split", [None, (1, 224), (2, 128), (7, 32)])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("Q", [1, 3])
def test_q8_split_emulation_matches_the_reference(Q, d, split):
    """The int8 pair at S = 200 with several ranks; row 0 at pos 0 leaves
    every rank but the first dead. Against the XLA bounded loop and the
    Pallas q8 kernel in interpret mode, and the port's plain loop."""
    B, H, S = 3, 2, 200
    rng = np.random.default_rng(Q * 100 + d)
    q = rng.standard_normal((B, H, Q, d)).astype(np.float32)
    kp, vp = _q8_pair(rng, (B, H, S, d)), _q8_pair(rng, (B, H, S, d))
    pos = np.asarray([0, 97, S - Q], np.int32)
    scale = d ** -0.5
    split = split or da.decode_split_q8(B, H, S, Q)
    nsplit, chunk = split
    assert nsplit * chunk >= S and S % chunk
    tq, tpos = torch.from_numpy(q), torch.from_numpy(pos)
    got = split_emulation(tq, _t_pair(kp), _t_pair(vp), tpos, scale,
                          split).numpy()
    jk = tuple(jnp.asarray(a) for a in kp)
    jv = tuple(jnp.asarray(a) for a in vp)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(pos), scale, 40)
    bounded = np.asarray(jda._xla_bounded_decode_attention(*jargs))
    kernel = np.asarray(_interpret(jda._pallas_decode_attention, *jargs))
    port = da.bounded_decode_attention(tq, _t_pair(kp), _t_pair(vp),
                                       tpos.long(), scale, 40).numpy()
    for ref in (bounded, kernel, port):
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)


def test_q8_split_emulation_matches_the_port_at_the_engine_split():
    """The engine's shape at its int8 split, 4 ranks of 128 keys, against
    the port's plain loop."""
    B, H, S, d = 8, 2, 512, 32
    rng = np.random.default_rng(8)
    tq = torch.from_numpy(rng.standard_normal((B, H, 1, d)).astype(
        np.float32)).bfloat16()
    tk = _t_pair(_q8_pair(rng, (B, H, S, d)))
    tv = _t_pair(_q8_pair(rng, (B, H, S, d)))
    pos = torch.tensor([round(511 * i / 7) for i in range(8)])
    split = da.decode_split_q8(B, 16, S, 1)
    assert split == (4, 128)
    got = split_emulation(tq, tk, tv, pos, 0.2, split)
    ref = da.bounded_decode_attention(tq, tk, tv, pos, 0.2, 128)
    torch.testing.assert_close(got, ref, atol=F32_TOL, rtol=F32_TOL)


def _q8_pools(rng, B, H, Q, d, ps, nb, pos):
    """q, a shuffled int8 pool pair (codes and steps) whose page 0 holds
    garbage, and a table whose entries past each row's live pages name
    page 0."""
    P = 1 + B * nb
    q = torch.from_numpy(rng.standard_normal((B, H, Q, d)).astype(np.float32))
    kp = _t_pair(_q8_pair(rng, (P, H, ps, d)))
    vp = _t_pair(_q8_pair(rng, (P, H, ps, d)))
    for (codes, steps), fill in ((kp, 127), (vp, -127)):
        codes[0], steps[0] = fill, 1e4
    ptab = torch.from_numpy(rng.permutation(P - 1) + 1)[:B * nb].reshape(
        B, nb).int()
    live_pages = (pos + Q + ps - 1) // ps
    ptab = torch.where(torch.arange(nb)[None] >= live_pages[:, None],
                       torch.zeros_like(ptab), ptab)
    return q, kp, vp, ptab


@pytest.mark.parametrize("ps", [8, 16, 128])
@pytest.mark.parametrize("Q", [1, 3])
def test_q8_paged_emulation_equals_the_view_bitwise(ps, Q):
    """The int8 pool, codes and steps read through the table (garbage in
    the scratch page 0 behind the dead entries), against the gathered
    dense view: the same float operations, the same bits."""
    B, H, d = 3, 2, 16
    nb = 256 // ps
    S = nb * ps
    pos = torch.tensor([0, 70, S - Q])
    q, kp, vp, ptab = _q8_pools(np.random.default_rng(ps * 10 + Q), B, H, Q,
                                d, ps, nb, pos)
    assert int((ptab == 0).sum()) > 0
    split = da.decode_split_q8(B, H, S, Q)
    assert split[0] > 1
    paged = split_emulation(q, kp, vp, pos, 0.25, split, ptab=ptab)
    dense = split_emulation(q, da.paged_view(kp, ptab),
                            da.paged_view(vp, ptab), pos, 0.25, split)
    assert torch.equal(paged, dense)
    assert bool(torch.isfinite(paged).all())
    ref = da.bounded_decode_attention(q, kp, vp, pos, 0.25, ps, ptab=ptab)
    torch.testing.assert_close(paged, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("ps,nb", [(8, 8), (16, 4), (128, 4), (128, 16)])
def test_q8_dense_call_over_the_view_splits_as_the_paged_call(monkeypatch,
                                                              ps, nb):
    """What the wrappers hand the int8 C entries: the dense launch over the
    gathered view and the paged launch get the same (nsplit, chunk),
    :func:`decode_split_q8` of that shape; q (bf16, a strided view) and pos
    (int64, expanded from a scalar) go as they are, with their strides; and
    each entry gets as many arguments as its argument types name (+ scale
    and stream)."""
    calls = _record_launch(monkeypatch)
    B, H, Q, d = 3, 16, 1, 128
    P = 1 + B * nb
    qkv = torch.zeros((B, Q, H, 3, d), dtype=torch.bfloat16)
    q = qkv[:, :, :, 0].transpose(1, 2)
    assert not q.is_contiguous()
    pool = (torch.zeros((P, H, ps, d), dtype=torch.int8),
            torch.ones((P, H, ps)))
    ptab = torch.arange(1, P, dtype=torch.int32).reshape(B, nb)
    view = tuple(t.contiguous() for t in da.paged_view(pool, ptab))
    pos = torch.tensor(9).expand(B)
    out = torch.empty((B, H, Q, d))
    da._launch(q, view, view, pos, out, 0.1)
    da._launch(q, pool, pool, pos, out, 0.1, ptab=ptab)
    (dn, dargs), (pn, pargs) = calls
    assert (dn, pn) == ("decode_attention_q8", "decode_attention_paged_q8")
    for name, args in calls:
        assert len(args) == len(da._ARGTYPES[name]) + 2
    split = da.decode_split_q8(B, H, nb * ps, Q)
    assert dargs[-4:-2] == pargs[-4:-2] == split
    for args, (codes, steps) in ((dargs, view), (pargs, pool)):
        assert args[:5] == (q.data_ptr(), 1, *q.stride()[:3])
        assert args[5:9] == (codes.data_ptr(), codes.data_ptr(),
                             steps.data_ptr(), steps.data_ptr())
    assert pargs[9] == ptab.data_ptr()
    assert dargs[9:12] == pargs[10:13] == (pos.data_ptr(), 1, 0)
    # the sizes: dense (B, H, S, Q, d), paged (B, H, P, ps, nb, Q, d)
    assert dargs[13:18] == (B, H, nb * ps, Q, d)
    assert pargs[14:21] == (B, H, P, ps, nb, Q, d)

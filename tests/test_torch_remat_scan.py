"""The main-path remnants of the port on the CPU at gpt_tiny, f32:
``remat_policy="dots"`` (a selective checkpoint that keeps the block's
weight products and recomputes the rest) against ``build_spmd_train_step``
on a one-device mesh and against the port's ``"full"`` policy, and the
per-token ``scan`` prefill mode against the reference's ``scan_prefill``
and the port's ``full`` mode, through ``prefill``, ``generate()`` and the
session's admission, dense and paged."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.inference import GenerationSession
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels.fused_adamw import tree_flatten

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
PREFILL_TOL = 2e-5


def _jcfg(n_layers=4, **kw):
    """The reference's gpt_tiny with ``n_layers`` layers."""
    return dataclasses.replace(jg.gpt_tiny(**kw), n_layers=n_layers)


def _batch(seed, B=2, S=32, vocab=256):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _flat_np(tree):
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(tree)]


# ================================================================= dots
def test_dots_train_steps_match_reference_and_full_policy():
    """Three AdamW steps: the losses equal the reference's dots step to
    f32 tolerance, and the port's dots and full policies are bitwise
    equal (the saved products are the values the recompute would make)."""
    kw = dict(remat=True, remat_policy="dots", xent_chunks=2,
              fused_adamw=True, n_layers=2)
    cfg_j = _jcfg(**kw)
    tree = jax.device_get(jg.init_params(cfg_j, 0))
    tokens, labels = _batch(1)
    step_j, shard = jg.build_spmd_train_step(
        cfg_j, jg.make_mesh(cfg_j, devices=np.array(jax.devices()[:1])),
        lr=LR)
    pj, oj = shard(jax.tree_util.tree_map(jnp.asarray, tree))
    ref = []
    for _ in range(STEPS):
        pj, oj, loss = step_j(pj, oj, jnp.asarray(tokens),
                              jnp.asarray(labels))
        ref.append(float(loss))
    sides = {}
    for policy in ("dots", "full"):
        cfg = tg.gpt_tiny(**dict(kw, remat_policy=policy))
        step = tg.build_train_step(cfg, lr=LR, device="cpu")
        p = tg.params_from_numpy(tree, cfg, device="cpu")
        o = tg.adamw_init(p, device="cpu")
        losses = []
        for _ in range(STEPS):
            p, o, loss = step(p, o, tokens, labels)
            losses.append(float(loss))
        sides[policy] = (losses, tree_flatten(p))
    losses, params = sides["dots"]
    for lj, lt in zip(ref, losses):
        assert abs(lj - lt) <= LOSS_TOL, (ref, losses)
    assert losses == sides["full"][0]
    for a, b in zip(params, sides["full"][1]):
        assert torch.equal(a, b)
    for x, y in zip(_flat_np(pj), params):
        np.testing.assert_allclose(y.numpy(), x, atol=2 * LR * STEPS, rtol=0)


def _grads(params, cfg, tokens, labels):
    leaves = [t.requires_grad_() for t in tree_flatten(params)]
    loss = tg.local_loss(params, cfg, torch.as_tensor(tokens).long(),
                         torch.as_tensor(labels).long())
    return loss, torch.autograd.grad(loss, leaves)


def test_dots_gradients_match_reference():
    """The loss and every gradient of the dots policy against the
    reference's ``jax.value_and_grad`` of its dots-checkpointed loss
    (1e-4 relative), and bitwise against the port's full policy."""
    cfg_j = _jcfg(remat=True, remat_policy="dots", n_layers=2)
    tree = jax.device_get(jg.init_params(cfg_j, 2))
    tokens, labels = _batch(3)
    loss_fn = jg._build_local_loss(cfg_j)
    specs = jg.param_specs(cfg_j)

    def local(params, tok, lab):
        # the reference train step's own gradient reduction
        loss, grads = jax.value_and_grad(loss_fn)(params, tok, lab)
        return loss, jax.tree_util.tree_map(
            lambda g, s: jg.psum_varying(g, jg._grad_psum_axes(s)), grads,
            specs)

    data = P((jg.AXIS_DP, jg.AXIS_EP, jg.AXIS_SHARD), (jg.AXIS_SP,))
    mesh = jg.make_mesh(cfg_j, devices=np.array(jax.devices()[:1]))
    lj, gj = jax.jit(jg.shard_map(local, mesh=mesh,
                                  in_specs=(specs, data, data),
                                  out_specs=(P(), specs)))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
        jnp.asarray(labels))
    out = {}
    for policy in ("dots", "full"):
        cfg = tg.gpt_tiny(remat=True, remat_policy=policy, n_layers=2)
        out[policy] = _grads(tg.params_from_numpy(tree, cfg, device="cpu"),
                             cfg, tokens, labels)
    lt, gt = out["dots"]
    assert abs(float(lj) - lt.item()) <= LOSS_TOL
    for x, y in zip(_flat_np(gj), gt):
        np.testing.assert_allclose(y.numpy(), x, atol=1e-6, rtol=GRAD_RTOL)
    assert torch.equal(lt, out["full"][0])
    for a, b in zip(gt, out["full"][1]):
        assert torch.equal(a, b)


class _Products(TorchDispatchMode):
    """Counts the products the dispatcher runs: 2-D mm by shape, bmm."""

    def __init__(self):
        super().__init__()
        self.mm, self.bmm = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm.append(tuple(tuple(a.shape) for a in args
                                 if isinstance(a, torch.Tensor)))
        elif func is torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_weight_products_and_recomputes_attention(
        monkeypatch):
    """What the dots policy keeps: per layer exactly the four weight
    products ([B*S, D] by qkv [D, 3D], proj [D, D], ffn-in [D, 4D],
    ffn-out [4D, D]) and nothing batched, so the attention scores (the
    plain attention's bmm on the CPU) are recomputed. The backward pass
    reruns no weight product under dots (full reruns three a layer: the
    recompute stops before ffn-out, whose output no backward reads) and
    the same attention bmm under both. Autograd's own saved tensors (what
    ``saved_tensors_hooks`` sees outside the checkpoint) are the blocks'
    inputs either way: the products live in the checkpoint's cache."""
    L, B, S = 2, 2, 16
    saved = []

    def policy(ctx, op, *args, **kwargs):
        decision = tg_policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision.name == "MUST_SAVE":
            saved.append((op, tuple(tuple(a.shape) for a in args
                                    if isinstance(a, torch.Tensor))))
        return decision

    tg_policy = tg._dots_policy
    monkeypatch.setattr(tg, "_dots_policy", policy)
    tokens, labels = _batch(5, B=B, S=S)
    out = {}
    for name in ("dots", "full"):
        cfg = tg.gpt_tiny(remat=True, remat_policy=name, n_layers=L)
        D = cfg.hidden
        params = tg.init_params(cfg, 0, device="cpu")
        leaves = [t.requires_grad_() for t in tree_flatten(params)]
        hooked = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: hooked.append(tuple(t.shape)) or t, lambda t: t):
            loss = tg.local_loss(params, cfg, torch.as_tensor(tokens).long(),
                                 torch.as_tensor(labels).long())
        count = _Products()
        with count:
            torch.autograd.grad(loss, leaves)
        out[name] = (sorted(hooked), count)
    N = B * S
    per_layer = [((N, D), (D, 3 * D)), ((N, D), (D, D)),
                 ((N, D), (D, 4 * D)), ((N, 4 * D), (4 * D, D))]
    assert [shapes for _, shapes in saved] == per_layer * L
    assert {op for op, _ in saved} == {torch.ops.aten.mm.default}
    assert out["dots"][0] == out["full"][0]
    dots, full = out["dots"][1], out["full"][1]
    # besides the backward's own products (dX and dW of each), full reruns
    # qkv, proj and ffn-in of every layer
    assert len(full.mm) - len(dots.mm) == 3 * L
    assert dots.bmm == full.bmm > 0


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tg.gpt_tiny(remat_policy="everything")


# ================================================================= scan
def _cfg_pair(**kw):
    return (dataclasses.replace(jg.gpt_tiny(), decode_block=8, **kw),
            tg.gpt_tiny(decode_block=8, **kw))


@pytest.fixture(scope="module")
def weights():
    """gpt_tiny weights for both packages, scaled so greedy streams vary
    token to token: (jcfg, jparams, tcfg, tparams)."""
    jcfg, tcfg = _cfg_pair()
    tree = jax.device_get(jg.init_params(jcfg, 4))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * 8.0
    tree["wte"] = tree["wte"] * 8.0
    tree["wpe"] = tree["wpe"] * 30.0
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            tg.params_from_numpy(tree, tcfg, device="cpu"))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)


def test_scan_prefill_dense_matches_reference_and_full(weights):
    """Rows of different lengths: each row's logits at its own last
    position and the whole caches equal the reference's scan_prefill and
    the port's one-pass prefill."""
    jcfg, jp, tcfg, tp = weights
    prompt = np.random.default_rng(4).integers(0, 256, (3, 7))
    lengths = np.array([7, 4, 1])
    jkc, jvc = jg.init_kv_cache(jcfg, 3, 16)
    jl, jkc, jvc = jg.scan_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32),
                                   jkc, jvc, lengths=jnp.asarray(lengths))
    caches = {}
    for mode in ("scan", "full"):
        kc, vc = tg.init_kv_cache(tcfg, 3, 16, device="cpu")
        fn = tg.scan_prefill if mode == "scan" else tg.prefill
        logits, _, _ = fn(tp, tcfg, torch.as_tensor(prompt), kc, vc,
                          lengths=torch.as_tensor(lengths))
        caches[mode] = (logits, kc, vc)
    logits, kc, vc = caches["scan"]
    _close(logits, jl)
    _close(kc, jkc)
    _close(vc, jvc)
    # the one-pass prefill writes the same positions [0, length) of each
    # row; past a row's length both hold garbage nobody reads
    for r, n in enumerate(lengths):
        for a, b in ((kc, caches["full"][1]), (vc, caches["full"][2])):
            _close(a[:, r, :, :n], b[:, r, :, :n])
    _close(logits, caches["full"][0])


def test_scan_prefill_paged_matches_reference(weights):
    """The paged pool: pages from a shuffled table, scan written through
    it, equal to the reference's paged scan_prefill."""
    jcfg, jp, tcfg, tp = weights
    prompt = np.random.default_rng(6).integers(0, 256, (2, 11))
    table = np.array([[3, 1], [2, 4]], np.int32)
    jkc, jvc = jg.init_kv_cache(jcfg, 5, 8)
    jl, jkc, jvc = jg.scan_prefill(
        jp, jcfg, jnp.asarray(prompt, jnp.int32), jkc, jvc,
        page_table=jnp.asarray(table), valid=jnp.ones((2,), bool))
    kc, vc = tg.init_kv_cache(tcfg, 5, 8, device="cpu")
    logits, _, _ = tg.scan_prefill(tp, tcfg, torch.as_tensor(prompt), kc, vc,
                                   page_table=torch.as_tensor(table))
    _close(logits, jl)
    _close(kc[:, 1:], jkc[:, 1:])   # page 0 is the scratch page
    _close(vc[:, 1:], jvc[:, 1:])


def test_generate_scan_streams_equal_reference_and_full(weights):
    jcfg, jp, tcfg, tp = weights
    prompt = np.random.default_rng(8).integers(0, 256, (2, 9))
    ref = np.asarray(jg.generate(jp, jcfg, jnp.asarray(prompt, jnp.int32),
                                 max_new_tokens=8, prefill_mode="scan"))
    for mode in ("scan", "full"):
        out = tg.generate(tp, tcfg, prompt, 8, prefill_mode=mode,
                          device="cpu")
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_session_scan_mode_matches_reference_session(weights, paged,
                                                     monkeypatch):
    """The session's whole-prompt admission in scan mode (from the
    argument and from PADDLE_TPU_PREFILL_MODE): streams equal the
    reference session's scan mode and the port's full mode, and rows
    admitted after others decode keep theirs intact."""
    jcfg, jp, tcfg, tp = weights
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, 256, (2, 10))
    late = rng.integers(0, 256, (1, 6))
    kw = dict(max_slots=3, max_prompt_len=12, max_len=40, kv_paged=paged)

    def drive(sess):
        first = sess.generate(prompts, [10, 7], 6)
        return first, sess.generate(late, None, 5)

    want = drive(JSession(jp, jcfg, prefill_mode="scan", **kw))
    got_scan = drive(GenerationSession(tp, tcfg, prefill_mode="scan",
                                       device="cpu", **kw))
    monkeypatch.setenv("PADDLE_TPU_PREFILL_MODE", "scan")
    got_env = drive(GenerationSession(tp, tcfg, device="cpu", **kw))
    monkeypatch.delenv("PADDLE_TPU_PREFILL_MODE")
    got_full = drive(GenerationSession(tp, tcfg, device="cpu", **kw))
    for got in (got_scan, got_env, got_full):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))

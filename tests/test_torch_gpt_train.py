"""The port's GPT train step (paddle_tpu_torch/models/gpt.py) against the
JAX reference on the CPU at gpt_tiny width: the same numpy weights and
batch through ``build_spmd_train_step`` on a one-device mesh and through
``build_train_step``."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels.fused_adamw import tree_flatten

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3
# f32 end to end; the two frameworks sum in other orders
LOSS_TOL = 1e-5
LOGIT_TOL = 1e-4


def _adamw_tol(steps, lr=LR):
    """AdamW moves each element by about lr a step whatever the size of
    its gradient (the first step is lr * g / (|g| + eps)), so an element
    whose gradient is summation noise can step the other way in the other
    framework: params agree to 2 * lr per step, not to f32 rounding. The
    loss and the gradients are held tightly instead."""
    return 2 * lr * steps


def _tree(cfg_j, seed=0):
    return jax.device_get(jg.init_params(cfg_j, seed))


def _batch(seed, B=4, S=64, vocab=256):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _one_device_mesh(cfg_j):
    return jg.make_mesh(cfg_j, devices=np.array(jax.devices()[:1]))


def _flat_np(tree):
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(tree)]


def _flat_torch(tree):
    return [t.float().numpy() for t in tree_flatten(tree)]


def _run_both(kw, steps=STEPS, dtype_j=jnp.float32, dtype_t=torch.float32):
    cfg_j = dataclasses.replace(jg.gpt_tiny(**kw), dtype=dtype_j)
    cfg_t = tg.gpt_tiny(dtype=dtype_t, **kw)
    tree = _tree(cfg_j)
    tokens, labels = _batch(1)
    step_j, shard = jg.build_spmd_train_step(cfg_j, _one_device_mesh(cfg_j),
                                             lr=LR)
    pj, oj = shard(jax.tree_util.tree_map(jnp.asarray, tree))
    step_t = tg.build_train_step(cfg_t, lr=LR, device="cpu")
    pt = tg.params_from_numpy(tree, cfg_t, device="cpu")
    ot = tg.adamw_init(pt, dtype=cfg_t.opt_dtype, device="cpu")
    losses = []
    for _ in range(steps):
        pj, oj, lj = step_j(pj, oj, jnp.asarray(tokens), jnp.asarray(labels))
        pt, ot, lt = step_t(pt, ot, tokens, labels)
        losses.append((float(lj), float(lt)))
    return losses, (pj, oj), (pt, ot)


@pytest.mark.parametrize("kw", [
    dict(remat=True, xent_chunks=1, fused_adamw=False),
    dict(remat=False, xent_chunks=2, fused_adamw=False),
    dict(remat=True, xent_chunks=2, fused_adamw=True),
    dict(remat=False, xent_chunks=1, fused_adamw=True, micro_batches=2),
], ids=["remat", "xent_chunks2", "fused_adamw", "micro_batches2"])
def test_train_step_matches_reference(kw):
    losses, (pj, oj), (pt, ot) = _run_both(kw)
    for lj, lt in losses:
        assert abs(lj - lt) <= LOSS_TOL, losses
    assert losses[-1][1] < losses[0][1]
    tol = _adamw_tol(STEPS)
    for name, a, b in (("params", _flat_np(pj), _flat_torch(pt)),
                       ("m", _flat_np(oj["m"]), _flat_torch(ot["m"]))):
        for x, y in zip(a, b):
            assert x.shape == y.shape
            np.testing.assert_allclose(y, x, atol=tol, rtol=0, err_msg=name)
    assert int(ot["step"]) == int(oj["step"]) == STEPS
    assert ot["step"].dtype == torch.int32


def test_train_step_bf16_tracks_reference():
    """bf16 params and activations, f32 moments: both sides round every
    product to bf16 but sum in other orders, so the loss agrees to about
    bf16's 2^-8 relative and the params to one bf16 rounding of |p| on
    top of the AdamW tolerance."""
    losses, (pj, _), (pt, _) = _run_both(
        dict(remat=True, xent_chunks=2, fused_adamw=True),
        dtype_j=jnp.bfloat16, dtype_t=torch.bfloat16)
    for lj, lt in losses:
        assert abs(lj - lt) <= 2 ** -8 * abs(lj), losses
    for x, y in zip(_flat_np(pj), _flat_torch(pt)):
        np.testing.assert_allclose(y, x, atol=_adamw_tol(STEPS),
                                   rtol=2 ** -7)


def test_gradients_match_reference():
    """The loss's gradients, the quantity AdamW hides, to f32 tolerance."""
    cfg_j = jg.gpt_tiny(remat=True, xent_chunks=2)
    cfg_t = tg.gpt_tiny(remat=True, xent_chunks=2)
    tree = _tree(cfg_j, seed=2)
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
    grad_fn = jax.jit(jg.shard_map(local, mesh=_one_device_mesh(cfg_j),
                                   in_specs=(specs, data, data),
                                   out_specs=(P(), specs)))
    lj, gj = grad_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                     jnp.asarray(tokens), jnp.asarray(labels))
    pt = tg.params_from_numpy(tree, cfg_t, device="cpu")
    leaves = [t.requires_grad_() for t in tree_flatten(pt)]
    lt = tg.local_loss(pt, cfg_t, torch.as_tensor(tokens).long(),
                       torch.as_tensor(labels).long())
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lj) - lt.item()) <= LOSS_TOL
    for x, y in zip(_flat_np(gj), gt):
        np.testing.assert_allclose(y.numpy(), x, atol=1e-6, rtol=1e-4)


def test_forward_matches_reference_entry_forward():
    """The forward of __graft_entry__.entry(): embedding, _stage_fn,
    final LayerNorm, f32 lm-head, at gpt_tiny in f32 (remat on and off)."""
    for remat in (False, True):
        cfg_j = jg.gpt_tiny(remat=remat)
        cfg_t = tg.gpt_tiny(remat=remat)
        tree = _tree(cfg_j, seed=5)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        tokens, _ = _batch(5, B=2, S=40)
        emb = jnp.take(params["wte"], jnp.asarray(tokens), axis=0)
        x = emb + params["wpe"][jnp.arange(tokens.shape[1])]
        x = jg._stage_fn(params["blocks"], x, cfg_j)
        x = jg._layer_norm(x, params["lnf_g"], params["lnf_b"])
        ref = jnp.einsum("bsd,vd->bsv", x.astype(jnp.float32),
                         params["wte"].astype(jnp.float32))
        got = tg.forward(tg.params_from_numpy(tree, cfg_t, device="cpu"),
                         cfg_t, tokens)
        assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_eval_step_matches_reference():
    cfg_j = jg.gpt_tiny(xent_chunks=2)
    cfg_t = tg.gpt_tiny(xent_chunks=2)
    tree = _tree(cfg_j, seed=7)
    tokens, labels = _batch(7)
    mesh = _one_device_mesh(cfg_j)
    _, shard = jg.build_spmd_train_step(cfg_j, mesh)
    pj, _ = shard(jax.tree_util.tree_map(jnp.asarray, tree))
    ref = jg.build_spmd_eval_step(cfg_j, mesh)(pj, jnp.asarray(tokens),
                                               jnp.asarray(labels))
    got = tg.build_eval_step(cfg_t, device="cpu")(
        tg.params_from_numpy(tree, cfg_t, device="cpu"), tokens, labels)
    assert not got.requires_grad
    assert abs(float(ref) - float(got)) <= LOSS_TOL


def test_xent_chunks_that_do_not_divide_fall_back_with_a_warning():
    cfg = tg.gpt_tiny()
    params = tg.init_params(cfg, seed=1, device="cpu")
    tokens, labels = (torch.as_tensor(a).long() for a in _batch(2, S=63))
    whole = tg.local_loss(params, cfg, tokens, labels)
    with pytest.warns(UserWarning, match="does not divide"):
        chunked = tg.local_loss(params, dataclasses.replace(cfg,
                                                            xent_chunks=2),
                                tokens, labels)
    assert float(whole) == float(chunked)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        three = tg.local_loss(params, dataclasses.replace(cfg, xent_chunks=3),
                              tokens, labels)
    assert abs(float(three) - float(whole)) <= LOSS_TOL
    with pytest.raises(ValueError, match="micro-batches"):
        tg.local_loss(params, dataclasses.replace(cfg, micro_batches=3),
                      tokens, labels)


@pytest.mark.parametrize("opt_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fused", [False, True])
def test_adamw_update_matches_reference(opt_dtype, fused):
    """_adamw_update on a bf16 tree: f32 moments take the fused path when
    asked, bf16 moments always the unfused one (as in the reference)."""
    rng = np.random.default_rng(9)
    shapes = {"a": (5, 7), "b": {"c": (11,)}}
    mk = lambda f: jax.tree_util.tree_map(f, shapes,
                                          is_leaf=lambda s: isinstance(s,
                                                                       tuple))
    p = mk(lambda s: rng.standard_normal(s).astype(np.float32))
    g = mk(lambda s: rng.standard_normal(s).astype(np.float32))
    jdt, tdt = ((jnp.float32, torch.float32) if opt_dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jtree = lambda t, dt: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                                 t)
    ttree = lambda t, dt: {k: ttree(v, dt) if isinstance(v, dict)
                           else torch.from_numpy(v).to(dt)
                           for k, v in t.items()}
    jp = jtree(p, jnp.bfloat16)
    jopt = jg.adamw_init(jp, dtype=jdt)
    tp = ttree(p, torch.bfloat16)
    topt = tg.adamw_init(tp, dtype=tdt, device="cpu")
    for _ in range(2):
        jp, jopt = jg._adamw_update(jp, jtree(g, jnp.bfloat16), jopt, 1e-2,
                                    fused=fused)
        tp, topt = tg._adamw_update(tp, ttree(g, torch.bfloat16), topt,
                                    1e-2, fused=fused)
    for ref, got in ((jp, tp), (jopt["m"], topt["m"]),
                     (jopt["v"], topt["v"])):
        for x, y in zip(_flat_np(ref), tree_flatten(got)):
            assert y.dtype == (torch.bfloat16 if ref is jp else tdt)
            np.testing.assert_allclose(y.float().numpy(), x, rtol=2 ** -8,
                                       atol=1e-6)
    assert int(topt["step"]) == 2


def test_trained_params_serve_without_conversion():
    cfg = tg.gpt_tiny(n_layers=2, fused_adamw=True)
    params = tg.init_params(cfg, seed=0, device="cpu")
    opt = tg.adamw_init(params, device="cpu")
    step = tg.build_train_step(cfg, lr=1e-2, device="cpu")
    tokens, labels = _batch(4, B=2, S=32)
    params, opt, _ = step(params, opt, tokens, labels)
    assert all(not t.requires_grad for t in tree_flatten(params))
    out = tg.generate(params, cfg, tokens[:, :5], 3, device="cpu")
    assert out.shape == (2, 8)


@pytest.mark.parametrize("field,value", [("mp", 2), ("dp", 2), ("pp", 2),
                                         ("moe_experts", 4),
                                         ("remat_policy", "dots")])
def test_config_guards(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP|later slice"):
        tg.gpt_tiny(**{field: value})


def test_sentinel_is_not_ported():
    with pytest.raises(NotImplementedError, match="training-guards"):
        tg.build_train_step(tg.gpt_tiny(), device="cpu", sentinel=True)


def test_config_defaults_match_reference():
    j, t = jg.GPTConfig(), tg.GPTConfig()
    for f in ("micro_batches", "remat", "remat_policy", "xent_chunks",
              "fused_adamw", "dropout", "dp", "pp", "mp", "sp", "sharding",
              "ep", "moe_experts"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.opt_dtype == torch.float32 and j.opt_dtype == jnp.float32

"""MoE on one device in the port (paddle_tpu_torch/parallel/moe.py and the
MoE paths of models/gpt.py and quantization/gpt_quant.py) against the JAX
reference on the CPU, at gpt_tiny width: gumbel and the gating bit for
bit, the routed expert's forward and gradients in both dispatch modes and
both wire dtypes, the flagship's training (losses, gradients, micro-
batches, the aux term) and serving (decode, chunked and scan prefill,
generate, w8kv8 and w4kv8, the session's graphed tick bodies and the
speculative lane)."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jg
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.quantization import gpt_quant as jq
from paddle_tpu_torch.framework import prng
from paddle_tpu_torch.inference import GenerationSession
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels.fused_adamw import tree_flatten
from paddle_tpu_torch.parallel import moe as tmoe
from paddle_tpu_torch.quantization import gpt_quant as tq
from paddle_tpu_torch.serving import ServingEngine, ServingFleet

torch.set_num_threads(1)
LR = 1e-3
# f32 end to end; the two frameworks sum in other orders
LOSS_TOL = 1e-5
LOGIT_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


# --------------------------------------------------------------- gumbel
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(5,), (3, 17), (2, 32, 8)])
def test_gumbel_bitwise(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = prng.gumbel(prng.PRNGKey(seed), shape, device="cpu")
    np.testing.assert_array_equal(_np(got), want)
    # a tensor key draws the same bits
    tk = torch.tensor(prng.PRNGKey(seed), dtype=torch.int64)
    assert torch.equal(prng.gumbel(tk, shape, device="cpu"), got)


def test_exp_and_softmax_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-100, 0, 1 << 16),
                        rng.normal(0, 3, 1 << 14),
                        [0.0, -0.0, -np.inf, -1e30, 88.0]]).astype(
        np.float32)
    np.testing.assert_array_equal(_np(prng.exp_f32(_t(x))),
                                  np.asarray(jnp.exp(x)))
    lg = rng.normal(0, 2, (4, 64, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tmoe.softmax_f32(_t(lg))),
        np.asarray(jax.nn.softmax(jnp.asarray(lg), axis=-1)))


# ---------------------------------------------------------------- gating
def _logits(kind, seed=0, G=2, S=32, E=8):
    if kind == "ties":
        return np.zeros((G, S, E), np.float32)     # every gate a tie
    spread = {"near": 0.05, "wide": 1.5}[kind]
    return np.random.default_rng(seed).normal(0, spread, (G, S, E)).astype(
        np.float32)


def _same_assign(ref, got):
    for name, a, b in zip(("experts", "slots", "gates", "valid"), ref[:4],
                          got[:4]):
        np.testing.assert_array_equal(_np(b), np.asarray(a), err_msg=name)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-6)


@pytest.mark.parametrize("cap", [16, 5])
@pytest.mark.parametrize("kind", ["near", "wide", "ties"])
def test_top2_assign_matches_reference(kind, cap):
    lg = _logits(kind)
    _same_assign(jmoe.top2_assign(jnp.asarray(lg), cap),
                 tmoe.top2_assign(_t(lg), cap))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", ["near", "ties"])
def test_top2_assign_key_jitter_matches_reference(kind, seed):
    lg = _logits(kind, seed=seed)
    ref = jmoe.top2_assign(jnp.asarray(lg), 16, key=jax.random.PRNGKey(seed))
    got = tmoe.top2_assign(_t(lg), 16, key=prng.PRNGKey(seed))
    _same_assign(ref, got)
    base = tmoe.top2_assign(_t(lg), 16)
    # only the second choice moves, and it does move
    assert torch.equal(got[0][..., 0], base[0][..., 0])
    assert (got[0][..., 1] != base[0][..., 1]).float().mean() > 0.1


@pytest.mark.parametrize("cap", [16, 3])
@pytest.mark.parametrize("kind", ["near", "wide", "ties"])
def test_switch_assign_matches_reference(kind, cap):
    lg = _logits(kind)
    _same_assign(jmoe.switch_assign(jnp.asarray(lg), cap),
                 tmoe.switch_assign(_t(lg), cap))


def test_dense_masks_and_inverted_map_match_reference():
    lg = _logits("wide")
    E, C = 8, 5
    ja = jmoe.top2_assign(jnp.asarray(lg), C)
    ta = tmoe.top2_assign(_t(lg), C)
    jc, jd = jmoe._dense_from_assign(*ja[:4], E, C)
    tc, td = tmoe._dense_from_assign(*ta[:4], E, C)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    T = lg.shape[0] * lg.shape[1]
    flat = [np.asarray(a).reshape(T, 2) for a in (ja[0], ja[1], ja[3])]
    want = jmoe._invert_assign(*(jnp.asarray(a) for a in flat), E, C)
    # slots are per group: offset group g's columns by g * C, as
    # moe_forward does, so the map stays injective
    got = tmoe._invert_assign(*(_t(a) for a in flat), E, C)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# -------------------------------------------------------- routed expert
D, F, NE = 16, 64, 8


def _layer_np(seed=0, E=NE):
    r = np.random.default_rng(seed)
    n = lambda *s: r.normal(0, 0.1, s).astype(np.float32)
    return {"gate": n(D, E), "w_in": n(E, D, F), "b_in": n(E, F),
            "w_out": n(E, F, D), "b_out": n(E, D)}


def _ffn_cfgs(**kw):
    kw = dict(dict(moe_experts=NE, moe_top_k=2, moe_capacity_factor=2.0),
              **kw)
    base = dict(vocab_size=64, hidden=D, n_layers=1, n_heads=2, max_seq=64)
    jkw = dict(kw)
    if "moe_dispatch_dtype" in kw and kw["moe_dispatch_dtype"] is \
            torch.bfloat16:
        jkw["moe_dispatch_dtype"] = jnp.bfloat16
    return (jg.GPTConfig(dtype=jnp.float32, **base, **jkw),
            tg.GPTConfig(dtype=torch.float32, **base, **kw))


def _ffn_value_and_grads(cfg_j, cfg_t, h, p):
    """Loss sum(y^2) + aux of one MoE FFN and its gradients (h, params),
    the reference's and the port's."""
    def loss_j(h, p):
        y, aux = jg._moe_ffn(h, p, cfg_j)
        return jnp.sum(y ** 2) + aux

    lj, (ghj, gpj) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jnp.asarray(h), jax.tree_util.tree_map(jnp.asarray, p))
    ht = _t(h).requires_grad_()
    pt = {k: _t(v).requires_grad_() for k, v in p.items()}
    y, aux = tg._moe_ffn(ht, pt, cfg_t)
    lt = (y ** 2).sum() + aux
    lt.backward()
    return (float(lj), np.asarray(ghj), {k: np.asarray(v)
                                         for k, v in gpj.items()}), \
        (float(lt.detach()), _np(ht.grad),
         {k: _np(v.grad) for k, v in pt.items()})


@pytest.mark.parametrize("mode", ["alltoall", "einsum"])
@pytest.mark.parametrize("top_k,cf", [(2, 4.0), (2, 0.5), (1, 0.5)],
                         ids=["top2", "top2_drop", "top1_drop"])
def test_moe_ffn_forward_and_grads_match_reference(mode, top_k, cf):
    h = np.random.default_rng(1).normal(size=(4, 16, D)).astype(np.float32)
    p = _layer_np()
    cfg_j, cfg_t = _ffn_cfgs(moe_top_k=top_k, moe_capacity_factor=cf,
                             moe_dispatch=mode)
    (lj, ghj, gpj), (lt, ght, gpt) = _ffn_value_and_grads(cfg_j, cfg_t, h, p)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    np.testing.assert_allclose(ght, ghj, atol=1e-5, err_msg="d/dh")
    for k in gpj:
        np.testing.assert_allclose(gpt[k], gpj[k], atol=1e-5,
                                   err_msg=f"d/d{k}")


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_wire_round_trip_matches_reference(wire):
    """dispatch_dtype rounds the buckets both ways and both passes at ep =
    1 too: the port's route equals the reference's, and both differ from
    the f32 wire."""
    h = np.random.default_rng(2).normal(size=(4, 16, D)).astype(np.float32)
    p = _layer_np(seed=3)
    dt = torch.bfloat16 if wire == "bf16" else "int8"
    cfg_j, cfg_t = _ffn_cfgs(moe_dispatch_dtype=dt)
    (lj, ghj, gpj), (lt, ght, gpt) = _ffn_value_and_grads(cfg_j, cfg_t, h, p)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    np.testing.assert_allclose(ght, ghj, atol=1e-5)
    for k in gpj:
        np.testing.assert_allclose(gpt[k], gpj[k], atol=1e-5, err_msg=k)
    f32 = _ffn_value_and_grads(*_ffn_cfgs(), h, p)[1]
    assert abs(f32[0] - lt) > 0, "the wire dtype rounded nothing"


def test_moe_forward_matches_reference_with_key():
    G, S, M, E = 1, 32, 8, 8
    r = np.random.default_rng(4)
    x = r.normal(size=(G, S, M)).astype(np.float32)
    gw = r.normal(0, 0.05, (M, E)).astype(np.float32)
    w = r.normal(0, 0.3, (E, M, M)).astype(np.float32)

    def jfn(ps, t):
        return jnp.tanh(t @ ps["w"])

    def tfn(ps, t):
        return torch.tanh(t @ ps["w"])

    for mode in ("alltoall", "einsum"):
        for key in (None, 3):
            want, _ = jmoe.moe_forward(
                jnp.asarray(x), jnp.asarray(gw), jfn, {"w": jnp.asarray(w)},
                4.0, 2, mode=mode,
                key=None if key is None else jax.random.PRNGKey(key))
            got, _ = tmoe.moe_forward(
                _t(x), _t(gw), tfn, {"w": _t(w)}, 4.0, 2, mode=mode,
                key=None if key is None else prng.PRNGKey(key))
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       atol=1e-6, err_msg=f"{mode} {key}")


# ------------------------------------------------------------ flagship
KW = dict(micro_batches=1, remat=False, moe_experts=4, moe_top_k=2,
          moe_capacity_factor=4.0)


def _data(seed=7, batch=4, seq=32):
    tok = np.random.default_rng(seed).integers(0, 256, (batch, seq))
    return tok.astype(np.int32), np.roll(tok, -1, 1).astype(np.int32)


def _run_port(cfg, tokens, labels, params=None, steps=1, lr=1e-2):
    params = params if params is not None else tg.init_params(
        cfg, seed=0, device="cpu")
    opt = tg.adamw_init(params, dtype=cfg.opt_dtype, device="cpu")
    step = tg.build_train_step(cfg, lr=lr, device="cpu")
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
    return losses, params


def _moe_params_from_dense(dense, E):
    """Every expert the dense FFN, a zero gate (uniform routing); copies,
    so a step on either tree (in place) leaves the other as it was."""
    dense = {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in dense.items()}
    b = dict(dense["blocks"])
    tile = lambda x: x[:, None].expand(x.shape[0], E, *x.shape[1:]).clone()
    L, Dm = b["w_in"].shape[:2]
    b["gate"] = torch.zeros((L, Dm, E), dtype=b["w_in"].dtype)
    for n in ("w_in", "b_in", "w_out", "b_out"):
        b[n] = tile(b[n])
    return dict(dense, blocks=b)


def test_single_expert_matches_dense():
    tokens, labels = _data(batch=4, seq=32)
    cfg_d = tg.gpt_tiny(micro_batches=1, remat=False)
    dense = tg.init_params(cfg_d, seed=0, device="cpu")
    moe = _moe_params_from_dense(dense, 1)
    loss_d, _ = _run_port(cfg_d, tokens, labels, params=dense)
    cfg_m = tg.gpt_tiny(micro_batches=1, remat=False, moe_experts=1,
                        moe_top_k=1, moe_capacity_factor=2.0,
                        moe_aux_weight=0.0)
    loss_m, _ = _run_port(cfg_m, tokens, labels, params=moe)
    assert abs(loss_d[0] - loss_m[0]) < 1e-5, (loss_d, loss_m)


def test_dense_path_unchanged_by_moe_plumbing():
    tokens, labels = _data(batch=2, seq=16)
    losses, p = _run_port(tg.gpt_tiny(micro_batches=1, remat=False,
                                      moe_experts=0), tokens, labels,
                          steps=2)
    assert all(np.isfinite(losses)) and "gate" not in p["blocks"]


def test_aux_weight_changes_gate_update_and_raises_loss():
    tokens, labels = _data()
    p0 = tg.init_params(tg.gpt_tiny(**KW), seed=0, device="cpu")
    copy = lambda t: {k: ({n: x.clone() for n, x in v.items()}
                          if isinstance(v, dict) else v.clone())
                      for k, v in t.items()}
    l_off, p_off = _run_port(tg.gpt_tiny(**KW, moe_aux_weight=0.0), tokens,
                             labels, params=copy(p0))
    l_on, p_on = _run_port(tg.gpt_tiny(**KW, moe_aux_weight=1.0), tokens,
                           labels, params=copy(p0))
    g0, g_off, g_on = (p["blocks"]["gate"] for p in (p0, p_off, p_on))
    assert (g_off - g0).abs().max() > 0, "gate never trains"
    assert (g_on - g_off).abs().max() > 1e-6, "aux term never reached it"
    l_big, _ = _run_port(tg.gpt_tiny(**KW, moe_aux_weight=10.0), tokens,
                         labels, params=copy(p0))
    assert l_big[0] > l_off[0] + 1e-3


def test_eval_loss_excludes_aux():
    tokens, labels = _data()
    p = tg.init_params(tg.gpt_tiny(**KW), seed=0, device="cpu")
    la = float(tg.build_eval_step(tg.gpt_tiny(**KW, moe_aux_weight=0.0),
                                  device="cpu")(p, tokens, labels))
    lb = float(tg.build_eval_step(tg.gpt_tiny(**KW, moe_aux_weight=10.0),
                                  device="cpu")(p, tokens, labels))
    assert abs(la - lb) < 1e-6


@pytest.mark.parametrize("bad", [dict(moe_dispatch="sorted"),
                                 dict(moe_top_k=3)])
def test_bad_moe_config_rejected_loudly(bad):
    with pytest.raises(ValueError, match="moe_dispatch|moe_top_k"):
        tg.gpt_tiny(moe_experts=4, **bad)


def _both_steps(kw, seed=0):
    cfg_j = jg.gpt_tiny(**kw)
    cfg_t = tg.gpt_tiny(**kw)
    tree = jax.device_get(jg.init_params(cfg_j, seed))
    mesh = jg.make_mesh(cfg_j, devices=np.array(jax.devices()[:1]))
    step_j, shard = jg.build_spmd_train_step(cfg_j, mesh, lr=LR)
    pj, oj = shard(jax.tree_util.tree_map(jnp.asarray, tree))
    pt = tg.params_from_numpy(tree, cfg_t, device="cpu")
    ot = tg.adamw_init(pt, device="cpu")
    return (step_j, pj, oj), (tg.build_train_step(cfg_t, lr=LR,
                                                  device="cpu"), pt, ot)


@pytest.mark.parametrize("kw", [
    dict(moe_dispatch="alltoall", remat=True),
    dict(moe_dispatch="einsum", remat=False, xent_chunks=2),
    # capacity binds, so routing the whole batch at once would drop other
    # tokens than routing each micro-batch on its own
    dict(moe_dispatch="alltoall", remat=False, micro_batches=2,
         moe_capacity_factor=1.0),
    dict(moe_dispatch="alltoall", remat=True, remat_policy="dots",
         moe_top_k=1, moe_capacity_factor=1.0),
], ids=["alltoall_remat", "einsum", "micro_batches2", "dots_top1_drop"])
def test_train_steps_match_reference(kw):
    kw = dict(KW, **kw)
    tokens, labels = _data(batch=4, seq=32)
    (sj, pj, oj), (st, pt, ot) = _both_steps(kw)
    losses = []
    for _ in range(3):
        pj, oj, lj = sj(pj, oj, jnp.asarray(tokens), jnp.asarray(labels))
        pt, ot, lt = st(pt, ot, tokens, labels)
        losses.append((float(lj), float(lt)))
    for lj, lt in losses:
        assert abs(lj - lt) <= LOSS_TOL, losses
    assert int(ot["step"]) == 3


def test_gradients_match_reference():
    """The MoE loss's gradients (aux term included, micro-batches routed
    apart) to 1e-4 of each leaf's largest."""
    kw = dict(KW, remat=True, micro_batches=2, moe_capacity_factor=1.0)
    cfg_j, cfg_t = jg.gpt_tiny(**kw), tg.gpt_tiny(**kw)
    tree = jax.device_get(jg.init_params(cfg_j, 4))
    tokens, labels = _data(seed=9)
    loss_fn = jg._build_local_loss(cfg_j)
    mesh = jg.make_mesh(cfg_j, devices=np.array(jax.devices()[:1]))
    from jax.sharding import PartitionSpec as P
    from paddle_tpu._compat import shard_map
    specs = jg.param_specs(cfg_j)
    data = P((jg.AXIS_DP, jg.AXIS_EP, jg.AXIS_SHARD), (jg.AXIS_SP,))
    lj, gj = jax.jit(shard_map(jax.value_and_grad(loss_fn), mesh=mesh,
                               in_specs=(specs, data, data),
                               out_specs=(P(), specs)))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
        jnp.asarray(labels))
    pt = tg.params_from_numpy(tree, cfg_t, device="cpu")
    leaves = [t.requires_grad_() for t in tree_flatten(pt)]
    from paddle_tpu_torch.ops.kernels.fused_adamw import tree_unflatten
    lt = tg.local_loss(tree_unflatten(pt, leaves), cfg_t,
                       torch.as_tensor(tokens).long(),
                       torch.as_tensor(labels).long())
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lt.detach()) - float(lj)) <= LOSS_TOL
    for a, b in zip(jax.tree_util.tree_leaves(gj), gt):
        a = np.asarray(a)
        np.testing.assert_allclose(_np(b), a, rtol=0,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-12))


def test_init_params_bitwise():
    cfg_j = dataclasses.replace(jg.gpt_tiny(moe_experts=4), n_layers=2)
    cfg_t = tg.gpt_tiny(moe_experts=4, n_layers=2)
    ref = jax.device_get(jg.init_params(cfg_j, 5))
    got = tg.init_params(cfg_t, 5, device="cpu")
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(ref)[0], tree_flatten(got)):
        np.testing.assert_array_equal(_np(b), np.asarray(a),
                                      err_msg=str(path))


# -------------------------------------------------------------- serving
def _serve_models(k=2, seed=2, **kw):
    cfg_j = jg.GPTConfig(vocab_size=128, hidden=64, n_layers=2, n_heads=4,
                         max_seq=64, dtype=jnp.float32, micro_batches=1,
                         remat=False, moe_experts=4, moe_top_k=k,
                         moe_capacity_factor=8.0, **kw)
    cfg_t = tg.GPTConfig(vocab_size=128, hidden=64, n_layers=2, n_heads=4,
                         max_seq=64, dtype=torch.float32, micro_batches=1,
                         remat=False, moe_experts=4, moe_top_k=k,
                         moe_capacity_factor=8.0, **kw)
    tree = jax.device_get(jg.init_params(cfg_j, seed))
    # scaled so greedy streams vary token to token
    for name in ("w_qkv", "w_o", "w_in", "w_out", "gate"):
        tree["blocks"][name] = tree["blocks"][name] * 8.0
    tree["wte"] = tree["wte"] * 8.0
    tree["wpe"] = tree["wpe"] * 30.0
    return (cfg_j, jax.tree_util.tree_map(jnp.asarray, tree), cfg_t,
            tg.params_from_numpy(tree, cfg_t, device="cpu"))


@pytest.mark.parametrize("k", [1, 2], ids=["switch", "top2"])
def test_moe_decode_matches_reference_and_full_forward(k):
    cfg_j, pj, cfg_t, pt = _serve_models(k)
    toks = np.random.default_rng(2).integers(0, 128, (2, 5))
    kj, vj = jg.init_kv_cache(cfg_j, 2, 8)
    kt, vt = tg.init_kv_cache(cfg_t, 2, 8, device="cpu")
    for i in range(5):
        lj, kj, vj = jg.decode_one_token(pj, cfg_j, jnp.asarray(toks[:, i]),
                                         jnp.int32(i), kj, vj)
        lt, kt, vt = tg.decode_one_token(pt, cfg_t, _t(toks[:, i]), i, kt,
                                         vt)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=LOGIT_TOL,
                                   rtol=0)
    # the training forward's capacity dispatch, capacity never binding
    full = tg.forward(pt, cfg_t, toks)[:, -1]
    np.testing.assert_allclose(_np(lt), _np(full), atol=2e-4, rtol=2e-4)


def test_moe_prefill_modes_and_generate_match_reference():
    cfg_j, pj, cfg_t, pt = _serve_models(seed=5, prefill_chunk=3)
    prompt = np.random.default_rng(5).integers(0, 128, (2, 7))
    want = np.asarray(jg.generate(pj, cfg_j, jnp.asarray(prompt, jnp.int32),
                                  max_new_tokens=6, prefill_mode="scan"))
    for mode in ("scan", "full", "chunked"):
        got = tg.generate(pt, cfg_t, prompt, 6, prefill_mode=mode,
                          device="cpu")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)
    P = prompt.shape[1]
    kj, vj = jg.init_kv_cache(cfg_j, 2, 16)
    kt, vt = tg.init_kv_cache(cfg_t, 2, 16, device="cpu")
    lj = jg.prefill(pj, cfg_j, jnp.asarray(prompt, jnp.int32), kj, vj,
                    mode="chunked")[0]
    lt = tg.prefill(pt, cfg_t, _t(prompt), kt, vt, mode="chunked")[0]
    np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=LOGIT_TOL)
    assert P == 7


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_moe_codes_and_streams_match_reference(bits):
    wq = {8: "int8", 4: "int4"}[bits]
    cfg_j, pj, cfg_t, pt = _serve_models(weight_quant=wq,
                                         kv_cache_dtype="int8")
    qj = jax.device_get(jq.quantize_gpt_params(pj, cfg_j, bits=bits))
    qt = tq.quantize_gpt_params(pt, cfg_t, bits=bits)
    for name in ("w_in", "w_out", "w_in_s", "w_out_s"):
        np.testing.assert_array_equal(_np(qt["blocks"][name]),
                                      np.asarray(qj["blocks"][name]),
                                      err_msg=name)
    assert tq.quant_param_stats(qt, cfg_t) == jq.quant_param_stats(qj,
                                                                   cfg_j)
    prompt = np.random.default_rng(8).integers(0, 128, (2, 6))
    want = np.asarray(jg.generate(qj, cfg_j, jnp.asarray(prompt, jnp.int32),
                                  max_new_tokens=6))
    carried = tg.params_from_numpy(qj, cfg_t, device="cpu")
    got = tg.generate(carried, cfg_t, prompt, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- sessions and engines
@contextlib.contextmanager
def _no_host_reads():
    def trap(*_a, **_k):
        raise AssertionError("host read inside a tick body")

    names = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
             "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    for n in names:
        setattr(torch.Tensor, n, trap)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("quant", [False, True], ids=["bf", "w8kv8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_session_matches_reference_and_bodies_read_nothing(paged, quant,
                                                           monkeypatch):
    """A MoE session's streams equal the reference session's; its decode
    and chunk tick bodies run under a guard against host reads and leave
    the tick state a twin's public calls leave."""
    from paddle_tpu.inference import GenerationSession as JSession
    monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN", "full")
    kw = dict(weight_quant="int8", kv_cache_dtype="int8") if quant else {}
    cfg_j, pj, cfg_t, pt = _serve_models(decode_block=8, **kw)
    if quant:
        pj = jq.quantize_gpt_params(pj, cfg_j, bits=8)
        pt = tg.params_from_numpy(jax.device_get(pj), cfg_t, device="cpu")
    skw = dict(max_slots=4, max_prompt_len=16, max_len=40, kv_paged=paged)
    prompts = np.random.default_rng(3).integers(0, 128, (3, 8)).astype(
        np.int32)
    lengths = [3, 8, 5]
    want = np.asarray(JSession(pj, cfg_j, **skw).generate(
        prompts, lengths, max_new_tokens=8))
    got = GenerationSession(pt, cfg_t, device="cpu", **skw).generate(
        prompts, lengths, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    sess, twin = (GenerationSession(pt, cfg_t, device="cpu", **skw)
                  for _ in range(2))
    for s in (sess, twin):
        s.admit(prompts[:2], lengths[:2])
        s.step()
    with _no_host_reads():
        sess._decode_body()
    twin._decode()
    for n, t in twin._tick_state().items():
        assert torch.equal(sess._tick_state()[n], t), n
    W = 4
    for s in (sess, twin):
        mid = s.alloc_slot(need_tokens=20)
    chunks = [(mid, prompts[2, :W], 0, False)]
    sess._assemble_chunks(chunks, W)
    if paged:
        sess._sync_ptab()
    with _no_host_reads():
        sess._chunk_body(W)
    twin.prefill_chunks(chunks, W)
    for n, t in twin._tick_state().items():
        assert torch.equal(sess._tick_state()[n], t), n


def test_spec_engine_and_fleet_streams_equal_plain():
    """spec_decode=2 greedy streams equal spec off; an engine with
    chunked prefill serves generate()'s streams, and so does a w4kv8
    two-replica fleet on paged sessions."""
    cfg_j, pj, cfg_t, pt = _serve_models(decode_block=8)
    prompts = np.random.default_rng(6).integers(0, 128, (3, 8)).astype(
        np.int32)
    lengths = [8, 4, 6]
    skw = dict(max_slots=4, max_prompt_len=16, max_len=40, device="cpu")
    plain = GenerationSession(pt, cfg_t, **skw).generate(
        prompts, lengths, max_new_tokens=10)
    spec = GenerationSession(pt, cfg_t, spec_decode=2, spec_draft_layers=1,
                             **skw).generate(prompts, lengths,
                                             max_new_tokens=10)
    np.testing.assert_array_equal(spec, plain)
    eng = ServingEngine(GenerationSession(pt, cfg_t, **skw),
                        prefill_chunk=4, device="cpu")
    reqs = [eng.submit(prompts[i, :lengths[i]], max_new_tokens=10)
            for i in range(3)]
    eng.run()
    wants = [tg.generate(pt, cfg_t, prompts[i:i + 1, :lengths[i]], 10,
                         device="cpu")[0, lengths[i]:].tolist()
             for i in range(3)]
    for i, r in enumerate(reqs):
        assert list(r.output) == wants[i], i
    eng.close()
    # two replicas on one weight tree, w4kv8, paged with prefix pools
    qcfg = dataclasses.replace(cfg_t, weight_quant="int4",
                               kv_cache_dtype="int8")
    qp = tq.quantize_gpt_params(pt, qcfg, bits=4)
    fleet = ServingFleet([(f"r{i}", ServingEngine(
        GenerationSession(qp, qcfg, kv_paged=True, **skw), prefill_chunk=8,
        prefix_cache_blocks=8, device="cpu")) for i in range(2)])
    reqs = [fleet.submit(prompts[i, :lengths[i]], max_new_tokens=10,
                         request_id=f"q{i}") for i in range(3)]
    fleet.run(deadline=120)
    for i, r in enumerate(reqs):
        assert list(r.output) == tg.generate(
            qp, qcfg, prompts[i:i + 1, :lengths[i]], 10,
            device="cpu")[0, lengths[i]:].tolist(), i
    fleet.close()

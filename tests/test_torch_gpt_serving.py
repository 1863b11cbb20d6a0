"""The port's GPT serving path (paddle_tpu_torch/models/gpt.py) against
the JAX reference at gpt_tiny width in f32 on the CPU: the same numpy
weights and prompts through both packages."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.framework import prng
from paddle_tpu_torch.models import gpt as tg

torch.set_num_threads(1)

LOGIT_TOL = 1e-4   # f32 end to end; the two frameworks sum in other orders


def _weights(seed=0, gain=8.0, wpe_gain=30.0):
    """Reference init with the matrices and position table scaled up, so
    greedy streams vary from token to token instead of repeating one."""
    tree = jax.device_get(jg.init_params(jg.gpt_tiny(), seed))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * gain
    tree["wte"] = tree["wte"] * gain
    tree["wpe"] = tree["wpe"] * wpe_gain
    return tree


def _jax_tiny(**kw):
    return dataclasses.replace(jg.gpt_tiny(), **kw)


@pytest.fixture(scope="module")
def models():
    tree = _weights()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tg.params_from_numpy(tree, tg.gpt_tiny(), device="cpu")
    return jg.gpt_tiny(), jp, tg.gpt_tiny(), tp


def _prompt(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, ref, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_config_and_params_carry_over(models):
    jcfg, jp, tcfg, tp = models
    for f in ("vocab_size", "hidden", "n_layers", "n_heads", "max_seq",
              "decode_block", "prefill_chunk"):
        assert getattr(tcfg, f) == getattr(jcfg, f)
    big_j, big_t = jg.gpt3_1p3b(), tg.gpt3_1p3b()
    assert (big_t.hidden, big_t.n_layers, big_t.n_heads, big_t.head_dim,
            big_t.vocab_size, big_t.max_seq) == (
        big_j.hidden, big_j.n_layers, big_j.n_heads, big_j.head_dim,
        big_j.vocab_size, big_j.max_seq)
    assert big_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["blocks"]["w_qkv"].numpy(),
                                  np.asarray(jp["blocks"]["w_qkv"]))
    # bf16 crosses as bits
    tree16 = jax.device_get(jg.init_params(_jax_tiny(dtype=jnp.bfloat16), 1))
    tp16 = tg.params_from_numpy(tree16, tg.gpt_tiny(dtype=torch.bfloat16),
                                device="cpu")
    assert tp16["wte"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp16["wte"].float().numpy(),
                                  np.asarray(tree16["wte"], np.float32))
    with pytest.raises(ValueError, match="shape"):
        tg.params_from_numpy(tree16, tg.gpt_tiny(n_layers=2), device="cpu")


def test_init_params_seeded_and_shaped():
    cfg = tg.gpt_tiny()
    a = tg.init_params(cfg, seed=3, device="cpu")
    b = tg.init_params(cfg, seed=3, device="cpu")
    c = tg.init_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["blocks"]["w_in"], b["blocks"]["w_in"])
    assert not torch.equal(a["wte"], c["wte"])
    assert a["blocks"]["w_qkv"].shape == (4, 64, 192)
    assert abs(a["wte"].std().item() - 0.02) < 2e-3
    assert torch.equal(a["blocks"]["ln1_g"], torch.ones(4, 64))
    ratio = a["blocks"]["w_o"].std() / a["blocks"]["w_qkv"].std()
    assert abs(ratio.item() - 1 / np.sqrt(8)) < 0.05


@pytest.mark.parametrize("mode,chunk", [("full", 0), ("chunked", 3),
                                        ("chunked", 4)])
def test_prefill_logits_and_cache_match(models, mode, chunk):
    jcfg, jp, tcfg, tp = models
    jcfg = dataclasses.replace(jcfg, prefill_chunk=chunk)
    tcfg = dataclasses.replace(tcfg, prefill_chunk=chunk)
    prompt = _prompt(1, (3, 10))
    lengths = np.asarray([10, 4, 7], np.int32)
    jk, jv = jg.init_kv_cache(jcfg, 3, 32)
    jl, jk, jv = jg.prefill(jp, jcfg, jnp.asarray(prompt), jk, jv,
                            lengths=jnp.asarray(lengths), mode=mode)
    tk, tv = tg.init_kv_cache(tcfg, 3, 32, device="cpu")
    tl, tk, tv = tg.prefill(tp, tcfg, torch.as_tensor(prompt).long(), tk, tv,
                            lengths=torch.as_tensor(lengths), mode=mode)
    assert tl.dtype == torch.float32 and tl.shape == (3, 256)
    _close(tl.numpy(), jl)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)


def test_decode_one_token_matches_with_per_row_positions(models):
    jcfg, jp, tcfg, tp = models
    prompt = _prompt(2, (2, 8))
    jk, jv = jg.init_kv_cache(jcfg, 2, 16)
    jl, jk, jv = jg.prefill(jp, jcfg, jnp.asarray(prompt), jk, jv)
    tk, tv = tg.init_kv_cache(tcfg, 2, 16, device="cpu")
    tl, tk, tv = tg.prefill(tp, tcfg, torch.as_tensor(prompt).long(), tk, tv)
    for pos in (8, np.asarray([9, 5], np.int32), np.asarray([15, 0])):
        tok = np.asarray(jnp.argmax(jl, -1))
        jl, jk, jv = jg.decode_one_token(jp, jcfg, jnp.asarray(tok),
                                         jnp.asarray(pos), jk, jv)
        tl, tk, tv = tg.decode_one_token(tp, tcfg, torch.tensor(tok).long(),
                                         torch.tensor(pos), tk, tv)
        _close(tl.numpy(), jl)
        _close(tk.numpy(), jk)


def test_prefill_suffix_matches_including_slid_window(models):
    """Two chunks per row at per-row offsets; the second chunk of row 1
    runs past the cache end, so its window slides left and must keep the
    resident prefix below the shift."""
    jcfg, jp, tcfg, tp = models
    S, C = 16, 6
    prompt = _prompt(3, (2, 14))
    jk, jv = jg.init_kv_cache(jcfg, 2, S)
    tk, tv = tg.init_kv_cache(tcfg, 2, S, device="cpu")
    for offs, lens in (([0, 0], [6, 6]), ([6, 12], [4, 2])):
        toks = np.zeros((2, C), np.int32)
        for r in range(2):
            toks[r, :lens[r]] = prompt[r, offs[r]:offs[r] + lens[r]]
        jl, jk, jv = jg.prefill_suffix(jp, jcfg, jnp.asarray(toks), jk, jv,
                                       jnp.asarray(offs, jnp.int32),
                                       jnp.asarray(lens, jnp.int32))
        tl, tk, tv = tg.prefill_suffix(tp, tcfg, torch.as_tensor(toks).long(),
                                       tk, tv, torch.as_tensor(offs),
                                       torch.as_tensor(lens))
        _close(tl.numpy(), jl)
    # only the live region [0, off + len) of each row is defined
    for r, end in enumerate((10, 14)):
        _close(tk.numpy()[:, r, :, :end], np.asarray(jk)[:, r, :, :end])
        _close(tv.numpy()[:, r, :, :end], np.asarray(jv)[:, r, :, :end])


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.0, 0, 0.0), (0.7, 0, 0.0), (1.0, 5, 0.0), (0.9, 0, 0.8),
    (1.3, 7, 0.5)])
def test_filtered_probs_matches(temp, top_k, top_p):
    logits = np.random.default_rng(4).standard_normal((3, 40)).astype(
        np.float32) * 3
    ref = jg.filtered_probs(jnp.asarray(logits), temp, top_k, top_p)
    got = tg.filtered_probs(torch.from_numpy(logits), temp, top_k, top_p)
    _close(got.numpy(), ref, 1e-6)
    temps = np.asarray([0.0, 0.5, 2.0], np.float32)     # per-row temperature
    _close(tg.filtered_probs(torch.from_numpy(logits), torch.from_numpy(temps),
                             top_k, top_p).numpy(),
           jg.filtered_probs(jnp.asarray(logits), jnp.asarray(temps), top_k,
                             top_p), 1e-6)


def test_sampling_respects_filter_and_seed(models):
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 50)).astype(np.float32))
    keys = prng.split(prng.PRNGKey(0), 30)
    draws = torch.stack([tg.sample_logits(logits, k, 1.0, top_k=3)
                         for k in keys])
    top3 = logits.topk(3).indices
    assert all((draws[:, b:b + 1] == top3[b]).any(-1).all()
               for b in range(4))
    assert torch.equal(tg.sample_logits(logits), logits.argmax(-1))
    # each draw is the reference's draw with the same threefry key
    ref = np.stack([np.asarray(jg.sample_logits(
        jnp.asarray(logits.numpy()), jnp.asarray(k, jnp.uint32), 1.0,
        top_k=3)) for k in keys])
    np.testing.assert_array_equal(draws.numpy(), ref)
    jcfg, jp, tcfg, tp = models
    a = tg.generate(tp, tcfg, _prompt(6, (2, 4)), 6, temperature=1.0,
                    top_k=8, seed=3, device="cpu")
    b = tg.generate(tp, tcfg, _prompt(6, (2, 4)), 6, temperature=1.0,
                    top_k=8, seed=3, device="cpu")
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.numpy(), np.asarray(jg.generate(
        jp, jcfg, _prompt(6, (2, 4)), 6, temperature=1.0, top_k=8, seed=3)))


@pytest.mark.parametrize("mode", ["full", "chunked"])
def test_greedy_generate_streams_equal(models, mode):
    jcfg, jp, tcfg, tp = models
    jcfg = dataclasses.replace(jcfg, prefill_chunk=4)
    tcfg = dataclasses.replace(tcfg, prefill_chunk=4)
    prompt = _prompt(7, (3, 9))
    ref = np.asarray(jg.generate(jp, jcfg, prompt, max_new_tokens=12,
                                 prefill_mode=mode))
    got = tg.generate(tp, tcfg, prompt, max_new_tokens=12,
                      prefill_mode=mode, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    # the streams discriminate: not one token repeated
    assert len(set(ref[0, 9:].tolist())) > 3


def test_mode_and_budget_checks(models):
    _, _, tcfg, tp = models
    # the scan A/B mode is ported; an unknown mode names the three
    assert tg.check_prefill_mode("scan") == "scan"
    with pytest.raises(ValueError, match="scan"):
        tg.check_prefill_mode("bogus")
    with pytest.raises(ValueError, match="max_seq"):
        tg.generate(tp, tcfg, _prompt(8, (1, 60)), 8, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        tg.generate(tp, tcfg, _prompt(8, (1, 6)), 2, prefill_mode="chunked",
                    device="cpu")
    # the scaled-int8 cache: (codes, steps) pairs
    kc, vc = tg.init_kv_cache(tg.gpt_tiny(kv_cache_dtype="int8"), 2, 16,
                              device="cpu")
    for codes, steps in (kc, vc):
        assert codes.dtype == torch.int8 and codes.shape == (4, 2, 4, 16, 16)
        assert steps.dtype == torch.float32 and steps.shape == (4, 2, 4, 16)
    for n, block in ((100, 128), (129, 128), (256, 128), (70, 8)):
        assert tg.pad_cache_len(n, block) == jg.pad_cache_len(n, block)


@pytest.mark.parametrize("model,cache", [("bf16", None), ("f32", "bf16")])
def test_bf16_model_or_cache_tracks_reference(model, cache):
    """bf16 weights, or an f32 model over a bf16 KV cache: the same
    LayerNorm cast order, cache rounding and f32 lm-head accumulation as
    the reference, within bf16 rounding."""
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}
    jcfg = _jax_tiny(dtype=jdt[model],
                     kv_cache_dtype=jdt[cache] if cache else None)
    tcfg = tg.gpt_tiny(dtype=tdt[model],
                       kv_cache_dtype=tdt[cache] if cache else None)
    tree = jax.device_get(jg.init_params(jcfg, 2))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tg.params_from_numpy(tree, tcfg, device="cpu")
    prompt = _prompt(9, (2, 8))
    jk, jv = jg.init_kv_cache(jcfg, 2, 16)
    jl, jk, jv = jg.prefill(jp, jcfg, jnp.asarray(prompt), jk, jv)
    tk, tv = tg.init_kv_cache(tcfg, 2, 16, device="cpu")
    tl, tk, tv = tg.prefill(tp, tcfg, torch.as_tensor(prompt).long(), tk, tv)
    assert tl.dtype == torch.float32 and tk.dtype == torch.bfloat16
    _close(tl.numpy(), jl, 2e-2)
    tok = np.asarray(jnp.argmax(jl, -1))
    jl, _, _ = jg.decode_one_token(jp, jcfg, jnp.asarray(tok), 8, jk, jv)
    tl, _, _ = tg.decode_one_token(tp, tcfg, torch.tensor(tok).long(), 8,
                                   tk, tv)
    _close(tl.numpy(), jl, 2e-2)

"""The port's quantized serving path against the JAX reference at gpt_tiny
in f32 on the CPU: weight-only int8/int4 FFN and lm-head, the scaled-int8
KV cache, and both together, through prefill, decode, suffix prefill,
generate(), GenerationSession and ServingEngine, on the same quantized
weights.

Tolerance. The weight codes are bit-equal (tests/test_torch_quant_cpu.py),
but the K/V codes are quantized from activations, which differ between
the frameworks by summation-order ulps; that can move a value across a
rounding tie, so one code moves by one step. Caches are therefore compared
dequantized, within one step of their position, and logits within
LOGIT_TOL (a one-step move of one K/V element moves a logit by far less).
Greedy streams must be equal."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.quantization import gpt_quant as jq
from paddle_tpu_torch.inference import GenerationSession
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.quantization import gpt_quant as tq
from paddle_tpu_torch.serving import RequestState, ServingEngine

torch.set_num_threads(1)

LOGIT_TOL = 1e-3
MODES = {"w8kv8": ("int8", "int8"), "w4kv8": ("int4", "int8"),
         "w8": ("int8", None), "kv8": (None, "int8")}


def _weights(seed=0, gain=8.0, wpe_gain=30.0):
    """Reference init with the matrices and position table scaled up, so
    greedy streams vary from token to token instead of repeating one."""
    tree = jax.device_get(jg.init_params(jg.gpt_tiny(), seed))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * gain
    tree["wte"] = tree["wte"] * gain
    tree["wpe"] = tree["wpe"] * wpe_gain
    return tree


def _models(mode, tree=None, **kw):
    """(jcfg, jparams, tcfg, tparams) of one quant mode: the reference
    quantizes, the port carries the quantized tree across."""
    wq, kv = MODES[mode]
    tree = _weights() if tree is None else tree
    jcfg = dataclasses.replace(jg.gpt_tiny(), weight_quant=wq,
                               kv_cache_dtype=kv, **kw)
    tcfg = tg.gpt_tiny(weight_quant=wq, kv_cache_dtype=kv, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if wq:
        jp = jq.quantize_gpt_params(jp, jcfg, jq.W_BITS[wq])
    tp = tg.params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=list(MODES))
def models(request):
    return (request.param,) + _models(request.param)


def _prompt(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, ref, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _cache_close(tcache, jcache, live=None):
    """Caches agree dequantized within one step of each position (an
    fp cache: within LOGIT_TOL). ``live``: [(row, end)] — only positions
    below ``end`` of each row are defined."""
    if isinstance(tcache, tuple):
        got = tg.kv_dequant(tcache).numpy()
        ref = np.asarray(jg.kv_dequant(jcache))
        tol = np.maximum(tcache[1].numpy(), np.asarray(jcache[1]))[..., None]
        tol = tol * 1.0001 + 1e-6
    else:
        got, ref = tcache.numpy(), np.asarray(jcache)
        tol = LOGIT_TOL * (1 + np.abs(ref))
    err = np.abs(got - ref) - tol
    if live is None:
        assert (err <= 0).all(), float(err.max())
    else:
        for r, end in live:
            assert (err[:, r, :, :end] <= 0).all(), (r, float(err.max()))


def test_quant_config_fields_and_cache_layout(models):
    mode, jcfg, _, tcfg, tp = models
    assert tcfg.weight_quant == jcfg.weight_quant
    assert tcfg.kv_cache_dtype == jcfg.kv_cache_dtype
    kc, vc = tg.init_kv_cache(tcfg, 2, 16, device="cpu")
    if MODES[mode][1]:
        assert isinstance(kc, tuple) and kc[0].dtype == torch.int8
        assert kc[0].shape == (4, 2, 4, 16, 16) and kc[1].shape == (4, 2, 4, 16)
        assert kc[1].dtype == torch.float32
    else:
        assert torch.is_tensor(kc) and kc.dtype == torch.float32
    if MODES[mode][0]:
        assert tp["wte"].dtype == torch.int8
        assert [lp["w_in_s"].shape for lp in tg.layer_params(tp)] == [
            (256,)] * 4
    with pytest.raises(ValueError, match="int8"):
        tg.gpt_tiny(kv_cache_dtype="fp8")


def test_prefill_and_decode_match_reference(models):
    mode, jcfg, jp, tcfg, tp = models
    prompt = _prompt(1, (3, 10))
    lengths = np.asarray([10, 4, 7], np.int32)
    jk, jv = jg.init_kv_cache(jcfg, 3, 32)
    jl, jk, jv = jg.prefill(jp, jcfg, jnp.asarray(prompt), jk, jv,
                            lengths=jnp.asarray(lengths))
    tk, tv = tg.init_kv_cache(tcfg, 3, 32, device="cpu")
    tl, tk, tv = tg.prefill(tp, tcfg, torch.as_tensor(prompt).long(), tk, tv,
                            lengths=torch.as_tensor(lengths))
    assert tl.dtype == torch.float32 and tl.shape == (3, 256)
    _close(tl.numpy(), jl)
    _cache_close(tk, jk)
    _cache_close(tv, jv)
    pos = lengths.copy()
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1))
        assert np.array_equal(tok, tl.argmax(-1).numpy())
        jl, jk, jv = jg.decode_one_token(jp, jcfg, jnp.asarray(tok),
                                         jnp.asarray(pos), jk, jv)
        tl, tk, tv = tg.decode_one_token(tp, tcfg, torch.tensor(tok).long(),
                                         torch.tensor(pos), tk, tv)
        _close(tl.numpy(), jl)
        pos = pos + 1
    live = [(r, int(p)) for r, p in enumerate(pos)]
    _cache_close(tk, jk, live)
    _cache_close(tv, jv, live)


@pytest.mark.parametrize("prefill_mode", ["full", "chunked"])
def test_greedy_generate_streams_equal(models, prefill_mode):
    mode, jcfg, jp, tcfg, tp = models
    jcfg = dataclasses.replace(jcfg, prefill_chunk=4)
    tcfg = dataclasses.replace(tcfg, prefill_chunk=4)
    prompt = _prompt(7, (3, 9))
    ref = np.asarray(jg.generate(jp, jcfg, prompt, max_new_tokens=12,
                                 prefill_mode=prefill_mode))
    got = tg.generate(tp, tcfg, prompt, max_new_tokens=12,
                      prefill_mode=prefill_mode, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(set(ref[0, 9:].tolist())) > 3


@pytest.mark.parametrize("mode", ["w8kv8", "w4kv8"])
def test_prefill_suffix_on_int8_cache_including_slid_window(mode):
    """Two chunks per row at per-row offsets; the second chunk of row 1
    runs past the cache end, so its window slides left and must keep the
    resident codes AND steps below the shift."""
    jcfg, jp, tcfg, tp = _models(mode)
    S, C = 16, 6
    prompt = _prompt(3, (2, 14))
    jk, jv = jg.init_kv_cache(jcfg, 2, S)
    tk, tv = tg.init_kv_cache(tcfg, 2, S, device="cpu")
    for offs, lens in (([0, 0], [6, 6]), ([6, 12], [4, 2])):
        toks = np.zeros((2, C), np.int32)
        for r in range(2):
            toks[r, :lens[r]] = prompt[r, offs[r]:offs[r] + lens[r]]
        if offs == [6, 12]:
            resident = tk[1][:, 1, :, 10:12].clone()
        jl, jk, jv = jg.prefill_suffix(jp, jcfg, jnp.asarray(toks), jk, jv,
                                       jnp.asarray(offs, jnp.int32),
                                       jnp.asarray(lens, jnp.int32))
        tl, tk, tv = tg.prefill_suffix(tp, tcfg, torch.as_tensor(toks).long(),
                                       tk, tv, torch.as_tensor(offs),
                                       torch.as_tensor(lens))
        _close(tl.numpy(), jl)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jl, -1)))
    # row 1's window slid to start 10: positions 10, 11 kept their steps
    assert torch.equal(tk[1][:, 1, :, 10:12], resident)
    live = [(0, 10), (1, 14)]
    _cache_close(tk, jk, live)
    _cache_close(tv, jv, live)


@pytest.mark.parametrize("chunk", [0, 4])
def test_w8kv8_session_and_engine_streams_equal(chunk):
    """Whole-prompt and chunked admission through the port's session and
    engine serve the streams of the port's solo generate() and of the
    reference's generate(); the session's byte accounting is the
    reference's."""
    jcfg, jp, tcfg, tp = _models("w8kv8", decode_block=8)
    rng = np.random.default_rng(21)
    trace = [(rng.integers(0, 256, (int(n),)).astype(np.int32), int(m))
             for n, m in zip(rng.integers(3, 15, 6), rng.integers(3, 9, 6))]
    sess = GenerationSession(tp, tcfg, max_slots=3, max_prompt_len=16,
                             max_len=40, device="cpu")
    eng = ServingEngine(sess, max_queue=16, prefill_chunk=chunk, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in trace]
    eng.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    for r, (p, m) in zip(reqs, trace):
        solo = tg.generate(tp, tcfg, p[None, :], max_new_tokens=m,
                           device="cpu")[0, len(p):].numpy()
        ref = np.asarray(jg.generate(jp, jcfg, p[None, :],
                                     max_new_tokens=m))[0, len(p):]
        np.testing.assert_array_equal(r.output, solo)
        np.testing.assert_array_equal(r.output, ref)
    jsess = JSession(jp, jcfg, max_slots=3, max_prompt_len=16, max_len=40)
    assert sess.quant_stats == jsess._quant_stats
    assert sess.quant_stats["weight_bits"] == 8
    assert sess.quant_stats["kv_bits"] == 8
    eng.close()


def test_session_generate_matches_reference_session():
    jcfg, jp, tcfg, tp = _models("w4kv8", decode_block=8)
    prompt = np.zeros((3, 8), np.int32)
    lens = [3, 5, 8]
    rng = np.random.default_rng(4)
    for i, n in enumerate(lens):
        prompt[i, :n] = rng.integers(0, 256, (n,))
    out = GenerationSession(tp, tcfg, max_slots=4, max_prompt_len=8,
                            device="cpu").generate(prompt, lengths=lens,
                                                   max_new_tokens=6)
    ref = JSession(jp, jcfg, max_slots=4, max_prompt_len=8).generate(
        prompt, lengths=lens, max_new_tokens=6)
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("mode,bits,floor", [("int8", 8, 0.9),
                                             ("int4", 4, 0.5)])
def test_top1_agreement_floor_against_own_fp_stream(mode, bits, floor):
    """The reference's agreement floors (tests/test_quantization.py) for
    the port's quantized stream against the port's fp stream."""
    tree = jax.device_get(jg.init_params(jg.gpt_tiny(), 0))
    cfg = tg.gpt_tiny()
    params = tg.params_from_numpy(tree, cfg, device="cpu")
    prompt = np.random.default_rng(6).integers(0, 256, (4, 8))
    ref = tg.generate(params, cfg, prompt, max_new_tokens=12,
                      device="cpu")[:, 8:]
    qcfg = tg.gpt_tiny(weight_quant=mode, kv_cache_dtype="int8")
    qp = tq.quantize_gpt_params(params, qcfg, bits)
    out = tg.generate(qp, qcfg, prompt, max_new_tokens=12,
                      device="cpu")[:, 8:]
    assert float((out == ref).float().mean()) >= floor


def test_training_ignores_weight_quant():
    """The reference's training path ignores cfg.weight_quant: the fp tree
    trains and evaluates the same with it set."""
    tree = _weights(1)
    cfg = tg.gpt_tiny(n_layers=2)
    qcfg = tg.gpt_tiny(n_layers=2, weight_quant="int8",
                       kv_cache_dtype="int8")
    params = tg.params_from_numpy(
        {**tree, "blocks": {k: v[:2] for k, v in tree["blocks"].items()}},
        cfg, device="cpu")
    tok = _prompt(5, (2, 9))
    losses = [float(tg.build_eval_step(c, device="cpu")(params, tok[:, :-1],
                                                        tok[:, 1:]))
              for c in (cfg, qcfg)]
    assert losses[0] == losses[1]
    assert torch.equal(tg.forward(params, cfg, tok),
                       tg.forward(params, qcfg, tok))
    with pytest.raises(ValueError, match="weight_quant"):
        GenerationSession(params, tg.gpt_tiny(n_layers=2, weight_quant="fp4"),
                          max_slots=1, device="cpu")

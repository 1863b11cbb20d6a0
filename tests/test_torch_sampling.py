"""Sampled decoding in the port against the JAX reference at gpt_tiny f32
on the CPU: generate(), the GenerationSession and the ServingEngine draw
with threefry keys (models/gpt.py sample_logits, generate's split chain,
the session's one split per decode tick), so their token streams equal
the reference's token for token."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.framework import prng
from paddle_tpu_torch.inference import GenerationSession
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.serving import ServingEngine

torch.set_num_threads(1)
VOCAB = 256


@pytest.fixture(scope="module")
def models():
    """gpt_tiny (decode_block 8, prefill_chunk 4) with the matrices and the
    position table scaled up, so streams vary token to token."""
    jcfg = dataclasses.replace(jg.gpt_tiny(), decode_block=8, prefill_chunk=4)
    tcfg = tg.gpt_tiny(decode_block=8, prefill_chunk=4)
    tree = jax.device_get(jg.init_params(jcfg, 3))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * 8.0
    tree["wte"] = tree["wte"] * 8.0
    tree["wpe"] = tree["wpe"] * 30.0
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, tcfg, tg.params_from_numpy(tree, tcfg, device="cpu")


SAMPLING = [(0.8, 0, 0.0, 0), (1.0, 5, 0.0, 1), (1.0, 0, 0.9, 2),
            (0.8, 7, 0.5, 0)]


@pytest.mark.parametrize("mode", ["full", "chunked"])
@pytest.mark.parametrize("temp,top_k,top_p,seed", SAMPLING)
def test_sampled_generate_equals_reference(models, mode, temp, top_k, top_p,
                                           seed):
    jcfg, jp, tcfg, tp = models
    prompt = np.random.default_rng(seed + 10).integers(
        0, VOCAB, (3, 9)).astype(np.int32)
    kw = dict(max_new_tokens=12, temperature=temp, top_k=top_k, top_p=top_p,
              seed=seed, prefill_mode=mode)
    ref = np.asarray(jg.generate(jp, jcfg, prompt, **kw))
    got = tg.generate(tp, tcfg, prompt, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the draws are not the greedy stream
    greedy = tg.generate(tp, tcfg, prompt, 12, prefill_mode=mode,
                         device="cpu")
    assert not torch.equal(got, greedy)


def test_sample_logits_takes_a_key(models):
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 50)).astype(np.float32) * 2)
    key = prng.PRNGKey(9)
    ref = jg.sample_logits(jnp.asarray(logits.numpy()),
                           jax.random.PRNGKey(9), 0.7, 3, 0.0)
    got = tg.sample_logits(logits, key, 0.7, 3, 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(tg.sample_logits(logits, None, 0.0),
                       logits.argmax(-1))


@pytest.mark.parametrize("temp,top_k,top_p,seed", SAMPLING[:3])
def test_sampled_session_equals_reference(models, temp, top_k, top_p, seed):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(40 + seed)
    padded = rng.integers(0, VOCAB, (3, 8)).astype(np.int32)
    lengths = [3, 8, 5]
    kw = dict(max_slots=4, max_prompt_len=8, temperature=temp, top_k=top_k,
              top_p=top_p, seed=seed)
    ref = JSession(jp, jcfg, **kw).generate(padded, lengths=lengths,
                                            max_new_tokens=7)
    got = GenerationSession(tp, tcfg, device="cpu", **kw).generate(
        padded, lengths=lengths, max_new_tokens=7)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("chunk", [0, 4])
def test_sampled_engine_trace_equals_reference(models, chunk):
    """The engine's polls split the session key once a decode tick, fused
    ticks included, as the reference's compiled tick does."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(21)
    trace = [(rng.integers(0, VOCAB, (int(n),)).astype(np.int32), int(m))
             for n, m in zip(rng.integers(3, 15, 7), rng.integers(3, 9, 7))]
    kw = dict(max_slots=3, max_prompt_len=16, max_len=40, temperature=0.9,
              top_k=6, seed=4)
    outs = []
    for eng in (ServingEngine(GenerationSession(tp, tcfg, device="cpu", **kw),
                              max_queue=16, prefill_chunk=chunk,
                              device="cpu"),
                JEngine(JSession(jp, jcfg, **kw), max_queue=16,
                        prefill_chunk=chunk)):
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in trace]
        eng.run()
        assert all(r.state.value == "done" for r in reqs)
        outs.append([list(r.output) for r in reqs])
        eng.close()
    assert outs[0] == outs[1]

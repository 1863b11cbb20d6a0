"""The port stands alone: no module under paddle_tpu_torch/ imports jax or
paddle_tpu, the package imports, serves (fp, quantized, and paged with
prefix reuse; greedy and sampled), trains, and runs the fused
bias-dropout-residual LayerNorm layer and the primitive factories with both
blocked, and every entry point defaults to the CUDA device and raises
without one."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "paddle_tpu"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_package_runs_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None      # any import of them now fails
        import numpy as np, torch
        torch.set_num_threads(1)
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.inference import GenerationSession
        from paddle_tpu_torch.serving import ServingEngine
        cfg = gpt.gpt_tiny(n_layers=2)
        params = gpt.init_params(cfg, seed=0, device="cpu")
        prompt = np.arange(10).reshape(2, 5) % cfg.vocab_size
        out = gpt.generate(params, cfg, prompt, 4, device="cpu")
        eng = ServingEngine(GenerationSession(params, cfg, max_slots=2,
                                              max_prompt_len=8,
                                              device="cpu"), device="cpu")
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompt]
        eng.run()
        assert [r.output for r in reqs] == out[:, 5:].tolist()
        cfg_t = gpt.gpt_tiny(n_layers=2, fused_adamw=True, xent_chunks=2)
        step = gpt.build_train_step(cfg_t, device="cpu")
        opt = gpt.adamw_init(params, device="cpu")
        tok = np.arange(34).reshape(2, 17) % cfg.vocab_size
        params, opt, loss = step(params, opt, tok[:, :-1], tok[:, 1:])
        assert np.isfinite(float(loss))
        from paddle_tpu_torch.quantization import quantize_gpt_params
        qcfg = gpt.gpt_tiny(n_layers=2, weight_quant="int4",
                            kv_cache_dtype="int8")
        qp = quantize_gpt_params(params, qcfg, bits=4)
        qout = gpt.generate(qp, qcfg, prompt, 4, device="cpu")
        sess = GenerationSession(qp, qcfg, max_slots=2, max_prompt_len=8,
                                 device="cpu")
        assert sess.quant_stats["weight_bits"] == 4
        eng = ServingEngine(sess, prefill_chunk=2, device="cpu")
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompt]
        eng.run()
        assert [r.output for r in reqs] == qout[:, 5:].tolist()
        cfg_p = gpt.gpt_tiny(n_layers=2, decode_block=4)
        sess = GenerationSession(params, cfg_p, max_slots=2,
                                 max_prompt_len=12, kv_paged=True,
                                 device="cpu")
        eng = ServingEngine(sess, prefill_chunk=4, prefix_cache_blocks=8,
                            prefix_promote_after=1, device="cpu")
        shared = np.arange(8) % cfg.vocab_size
        reqs = [eng.submit(np.concatenate([shared, [t, t + 1]]),
                           max_new_tokens=3) for t in (20, 30, 40)]
        eng.run()
        assert all(len(r.output) == 3 for r in reqs)
        assert eng.metrics()["prefix_cache"]["hits"] >= 2
        assert sum(r.prefix_hit_tokens for r in reqs) >= 8
        import paddle_tpu_torch
        from paddle_tpu_torch.framework import prng
        from paddle_tpu_torch.incubate.nn import (
            FusedBiasDropoutResidualLayerNorm)
        from paddle_tpu_torch.ops.kernels.primitives import (
            elementwise_kernel, reduce_kernel)
        s1 = gpt.generate(params, cfg, prompt, 4, temperature=0.8, top_k=5,
                          seed=1, device="cpu")
        assert torch.equal(s1, gpt.generate(params, cfg, prompt, 4,
                                            temperature=0.8, top_k=5, seed=1,
                                            device="cpu"))
        assert int(prng.bits(prng.PRNGKey(0), (), "cpu")) == 0xF29A4FA7
        layer = FusedBiasDropoutResidualLayerNorm(16, 0.2, device="cpu")
        paddle_tpu_torch.seed(3)
        x = torch.randn(2, 3, 16)
        y = layer(x, x)
        paddle_tpu_torch.seed(3)
        assert torch.equal(y, layer(x, x)) and y.shape == (2, 3, 16)
        y.sum().backward()
        sq = elementwise_kernel(lambda v: v * v, 8)(x)
        assert torch.allclose(reduce_kernel(torch.sum, 0.0, 8)(sq),
                              (x * x).sum())
        import paddle_tpu_torch as paddle
        paddle.set_device("cpu")
        paddle.seed(0)
        net = paddle.models.LeNet()
        opt = paddle.optimizer.Adam(1e-3, parameters=net.parameters())
        loss = paddle.nn.CrossEntropyLoss()(
            net(paddle.randn([4, 1, 28, 28])), paddle.to_tensor([1, 2, 3, 4]))
        loss.backward()
        opt.step()
        eager = gpt.GPT(gpt.gpt_tiny(n_layers=1))
        assert eager(paddle.to_tensor(prompt)).shape == [2, 5, 256]
        assert not any(m and m.startswith(("jax", "paddle_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
        """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_rnn_slice_runs_with_jax_blocked(tmp_path):
    """The profiler, the recurrent layers and beam search, the sequence
    losses, autograd.functional, L-BFGS, nn.utils, regularizer and the
    consumed-graph backward, with jax and the reference blocked."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None
        import os
        import numpy as np, torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch import profiler
        paddle.set_device("cpu")
        os.environ["PADDLE_TPU_PROFILE_DIR"] = {str(tmp_path)!r}
        prof = profiler.Profiler()
        prof.start()
        with profiler.RecordEvent("lm_step"):
            paddle.seed(0)
            emb = paddle.nn.Embedding(50, 8)
            lstm = paddle.nn.LSTM(8, 8, num_layers=2, dropout=0.5)
            fc = paddle.nn.Linear(8, 50)
            params = (emb.parameters() + lstm.parameters()
                      + fc.parameters())
            opt = paddle.optimizer.SGD(
                1.0, parameters=params,
                grad_clip=paddle.nn.ClipGradByGlobalNorm(5.0),
                weight_decay=paddle.regularizer.L2Decay(1e-4))
            tok = paddle.to_tensor(np.arange(40).reshape(4, 10) % 50)
            y, (h, c) = lstm(emb(tok[:, :-1]))
            loss = paddle.nn.functional.cross_entropy(
                paddle.reshape(fc(y), [-1, 50]),
                paddle.reshape(tok[:, 1:], [-1]))
            loss.backward()
            opt.step()
        prof.stop()
        prof.export({str(tmp_path / "out")!r})
        assert os.path.exists({str(tmp_path / "out" / "merged_trace.json")!r})
        assert "lm_step" in prof.summary()
        assert np.isfinite(float(loss)) and h.shape == [2, 4, 8]
        dec = paddle.nn.BeamSearchDecoder(
            paddle.nn.LSTMCell(8, 8), 0, 1, 3, embedding_fn=emb,
            output_fn=fc)
        h0 = paddle.zeros([2, 8])
        ids, lens = paddle.nn.dynamic_decode(dec, inits=(h0, h0),
                                             max_step_num=4)
        assert ids.shape[0] == 2 and ids.shape[2] == 3
        for layer in (paddle.nn.GRU(8, 8, direction="bidirect"),
                      paddle.nn.SimpleRNN(8, 8, time_major=True)):
            assert layer(paddle.randn([3, 4, 8]))[0].shape[2] in (8, 16)
        p = paddle.Parameter(np.array([5.0, -3.0], np.float32))
        lb = paddle.optimizer.LBFGS(parameters=[p],
                                    line_search_fn="strong_wolfe")
        def closure():
            lb.clear_grad()
            loss = ((p - paddle.to_tensor([1.0, 2.0])) ** 2).sum()
            loss.backward()
            return loss
        lb.step(closure)
        assert np.allclose(p.numpy(), [1.0, 2.0], atol=1e-4)
        x = paddle.to_tensor(np.array([1.0, 2.0], np.float32))
        assert np.allclose(paddle.autograd.jacobian(
            lambda t: paddle.sum(t * t), x).numpy(), [2.0, 4.0])
        paddle.nn.utils.weight_norm(fc)
        assert fc(paddle.zeros([1, 8])).shape == [1, 50]
        F = paddle.nn.functional
        assert F.rnnt_loss(paddle.randn([1, 3, 3, 4]),
                           paddle.to_tensor([[1, 2]]), paddle.to_tensor([3]),
                           paddle.to_tensor([2])).shape == []
        assert F.ctc_loss(F.log_softmax(paddle.randn([5, 2, 4])),
                          paddle.to_tensor([[1, 2], [3, 1]]),
                          paddle.to_tensor([5, 5]),
                          paddle.to_tensor([2, 2])).shape == []
        x = paddle.to_tensor(np.ones((2, 2), np.float32),
                             stop_gradient=False)
        hh = x * x
        yy = paddle.sum(hh * 3.0 + x)
        paddle.sum(hh * 2.0).backward()
        yy.backward()
        assert np.allclose(x.grad.numpy(), 5.0)
        assert not any(m and m.startswith(("jax", "paddle_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
        """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.framework import prng
    from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
    from paddle_tpu_torch.inference import GenerationSession
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.kernels.fused_adamw import fused_adamw_update
    from paddle_tpu_torch.serving import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_q8)
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.quantization import quantize_gpt_params
    cfg = gpt.gpt_tiny(n_layers=1)
    params = gpt.init_params(cfg, device="cpu")
    sess = GenerationSession(params, cfg, max_slots=1, device="cpu")
    as_numpy = lambda p: {k: (v.numpy() if torch.is_tensor(v)
                              else {n: t.numpy() for n, t in v.items()})
                          for k, v in p.items()}
    tree = as_numpy(params)
    qcfg = gpt.gpt_tiny(n_layers=1, weight_quant="int8",
                        kv_cache_dtype="int8")
    qparams = quantize_gpt_params(params, qcfg, bits=8)
    qtree = as_numpy(qparams)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "init_params": lambda: gpt.init_params(cfg),
        "params_from_numpy": lambda: gpt.params_from_numpy(tree, cfg),
        "init_kv_cache": lambda: gpt.init_kv_cache(cfg, 1),
        "generate": lambda: gpt.generate(params, cfg, np.zeros((1, 2)), 1),
        "GenerationSession": lambda: GenerationSession(params, cfg, 1),
        "ServingEngine": lambda: ServingEngine(sess),
        "build_train_step": lambda: gpt.build_train_step(cfg),
        "build_eval_step": lambda: gpt.build_eval_step(cfg),
        "adamw_init": lambda: gpt.adamw_init(params),
        "fused_adamw_update": lambda: fused_adamw_update(
            params, params, params, params, 0, 1e-3),
        "explicit cuda": lambda: resolve_device("cuda"),
        "params_from_numpy(quantized)": lambda: gpt.params_from_numpy(
            qtree, qcfg),
        "init_kv_cache(int8)": lambda: gpt.init_kv_cache(qcfg, 1),
        "generate(w8kv8)": lambda: gpt.generate(qparams, qcfg,
                                                np.zeros((1, 2)), 1),
        "GenerationSession(w8kv8)": lambda: GenerationSession(qparams, qcfg,
                                                              1),
        "FusedBiasDropoutResidualLayerNorm": lambda:
            FusedBiasDropoutResidualLayerNorm(8),
        "prng.bits": lambda: prng.bits(prng.PRNGKey(0), (2, 3)),
        "prng.bits(scalar)": lambda: prng.bits(prng.PRNGKey(0)),
        "prng.uniform": lambda: prng.uniform(prng.PRNGKey(0), (2, 3)),
        "prng.normal": lambda: prng.normal(prng.PRNGKey(0), (2, 3)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    # the quantized kernels' wrappers: a tensor on no kernel's device raises
    meta = lambda t: t.to("meta")
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        quant_matmul(x, torch.zeros((4, 3), dtype=torch.int8, device="meta"),
                     torch.zeros(3, device="meta"), 8)
    kc = tuple(map(meta, gpt.init_kv_cache(qcfg, 1, device="cpu")[0]))
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention_q8(torch.zeros((1, 4, 1, 16), device="meta"),
                            tuple(c[0] for c in kc), tuple(c[0] for c in kc),
                            torch.zeros(1, device="meta"))
    # CPU params handed to a CUDA call are refused, never moved silently
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="params live on cpu"):
        gpt.generate(params, cfg, np.zeros((1, 2)), 1)
    tokens = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="params live on cpu"):
        gpt.build_train_step(cfg)(params, None, tokens, tokens)
    with pytest.raises(ValueError, match="params live on cpu"):
        gpt.build_eval_step(cfg)(params, tokens, tokens)


def test_eager_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    """The eager surface puts new tensors on the current place, the card
    unless set_device chose the CPU; without a card every entry point
    raises instead of carrying on on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.models import gpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(place, "_current_place", None)
    assert place.get_device() == "gpu:0"
    calls = {
        "to_tensor": lambda: paddle.to_tensor([1.0, 2.0]),
        "zeros": lambda: paddle.zeros([2]),
        "arange": lambda: paddle.arange(4),
        "randn": lambda: paddle.randn([2]),
        "Linear": lambda: paddle.nn.Linear(2, 2),
        "LeNet": lambda: paddle.models.LeNet(),
        "eager GPT": lambda: gpt.GPT(gpt.gpt_tiny(n_layers=1)),
        "set_device(gpu)": lambda: paddle.set_device("gpu"),
        "load": lambda: paddle.load(__file__),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    paddle.set_device("cpu")
    assert paddle.to_tensor([1.0]).place == place.CPUPlace()

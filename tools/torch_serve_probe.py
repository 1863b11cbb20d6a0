#!/usr/bin/env python3
"""Time one served call of the exported O2 bf16 GPT(gpt3_1p3b) at [1, 2048]
in a process of its own, on one NVIDIA card, beside the eager layer.

    python3 tools/torch_serve_probe.py

The script builds the flash forward from the checkout's sources, makes the
eager GPT (random weights, ``paddle.seed(0)``), casts it with
``amp.decorate(level="O2")``, exports it with ``jit.save`` and loads it
with ``jit.load`` and ``inference.create_predictor``. For the eager
layer, the loaded layer (``TranslatedLayer``), the program module it
runs, called on the raw tensor, and the predictor's handle form (outputs
kept on the card) it prints the wall ms of a call (10 calls back to
back after 2 warm-ups), the host's ms to enqueue one call after a
synchronize (median of 5), the device ms of a call (torch.profiler,
summed kernel time) and the six Python functions with the most own time
a call (cProfile over 5 calls). It then times both again after a
``torch.compile`` (inductor) of a small function and after 25
torch.profiler sessions, the two things ``chip_smoke.py``'s ``jit`` phase
runs before it serves. The first line is the card's name and power
limit; the last is one JSON object with every figure.
"""
from __future__ import annotations

import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    from torch.profiler import ProfilerActivity, profile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.kernels import _build
    _build.build(["flash_attention_fwd"])
    paddle.set_device("gpu")
    cfg = gpt.gpt3_1p3b(dtype=torch.float32)
    paddle.seed(0)
    model = gpt.GPT(cfg)
    paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    model.eval()
    g = torch.Generator().manual_seed(0)
    tokens = paddle.to_tensor(torch.randint(
        0, cfg.vocab_size, (1, 2048), generator=g).numpy())
    path = os.path.join(tempfile.mkdtemp(prefix="serve_probe_"), "gpt")
    paddle.jit.save(model, path, input_spec=[
        paddle.jit.InputSpec([1, 2048], "int64")])
    loaded = paddle.jit.load(path)
    pred = paddle.inference.create_predictor(paddle.inference.Config(path))
    handle = pred.get_input_handle(pred.get_input_names()[0])
    tok_np, tok_raw = tokens.numpy(), tokens._value
    sync = torch.cuda.synchronize

    def predictor():
        handle.copy_from_cpu(tok_np)
        pred.run()
        return pred._outputs[0]

    def measure(fn):
        with paddle.no_grad():
            for _ in range(2):
                fn()
            sync()
            t = time.perf_counter()
            for _ in range(10):
                fn()
            sync()
            wall = (time.perf_counter() - t) / 10 * 1e3
            host = []
            for _ in range(5):
                sync()
                t = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t) * 1e3)
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                sync()
            dev_us = sum(getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                         for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
            pr = cProfile.Profile()
            pr.enable()
            for _ in range(5):
                fn()
            sync()
            pr.disable()
        top = sorted(pstats.Stats(pr).stats.items(),
                     key=lambda kv: -kv[1][2])[:6]
        return dict(wall_ms=round(wall, 3),
                    host_enqueue_ms=round(sorted(host)[2], 3),
                    device_ms=round(dev_us / 3e3, 3),
                    own_ms=[(f"{os.path.basename(f)}:{ln}({n})",
                             round(v[2] / 5 * 1e3, 3))
                            for (f, ln, n), v in top])

    res = {}

    def report(tag):
        res[tag] = {"eager layer": measure(lambda: model(tokens)),
                    "jit.load": measure(lambda: loaded(tokens)),
                    "program module": measure(
                        lambda: loaded._program(tok_raw)),
                    "predictor": measure(predictor)}
        print(tag, json.dumps(res[tag]), flush=True)

    report("fresh")
    f = torch.compile(lambda a, b: torch.relu(a @ b) + 1, fullgraph=True)
    a = torch.randn(64, 64, device="cuda")
    f(a, a)
    sync()
    report("after an inductor compile")
    for _ in range(25):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with paddle.no_grad():
                loaded(tokens)
            sync()
        prof.key_averages()
    report("after 25 profiler sessions")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

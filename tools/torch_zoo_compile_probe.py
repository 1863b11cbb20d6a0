#!/usr/bin/env python3
"""Time jit.to_static(resnet50) on the card under inductor settings.

    python3 tools/torch_zoo_compile_probe.py '{"triton.autotune_pointwise": true}'

Builds vision.models.resnet50(num_classes=1000) (f32, TF32 off), runs one
eager Momentum step on a seeded B=64 x 3x224x224 batch, then compiles it
with paddle_tpu_torch.jit.to_static after the given
torch._inductor.config settings (a JSON object) have updated to_static's
own (jit.INDUCTOR_OPTIONS; {} keeps them). Prints, as one JSON line: the
seconds of the first compiled step (forward and backward compiles
included), the compile seconds by torch's timers, and the next two
steps' ms. Run one setting a process: a process caches what it compiled.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_zoo_compile_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {}
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50
    from torch._dynamo.utils import compilation_time_metrics
    paddle.set_device("gpu")
    paddle.seed(0)
    model = resnet50(num_classes=1000)
    model.train()
    rng = np.random.default_rng(11)
    x = paddle.to_tensor(rng.standard_normal((64, 3, 224, 224),
                                             dtype=np.float32))
    y = paddle.to_tensor(rng.integers(0, 1000, (64,)))
    opt = paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=model.parameters(),
        weight_decay=paddle.optimizer.L2Decay(1e-4))

    def step():
        t0 = time.perf_counter()
        loss = paddle.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        float(loss)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    step()
    paddle.jit.INDUCTOR_OPTIONS.update(settings)
    paddle.jit.to_static(model)
    first = step()
    after = [round(step() * 1e3, 3) for _ in range(2)]
    parts = sorted(((k, round(sum(v), 2)) for k, v in
                    compilation_time_metrics.items()),
                   key=lambda kv: -kv[1])[:12]
    print(json.dumps(dict(settings=model._static_function.options,
                          first_step_s=round(first, 2),
                          compile_seconds_by_timer=dict(parts),
                          step_ms=after,
                          compiles=model._static_function.compiles)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

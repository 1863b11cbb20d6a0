#!/usr/bin/env python3
"""Time quant_matmul's decode form and the fused bias-dropout-residual
LayerNorm of the PyTorch port on one NVIDIA card, for one or more trees of
the repository in turn, so that two versions are compared inside one run.

    python3 tools/torch_kernel_ab.py OLD NEW NEW OLD    # trees, in turns
    python3 tools/torch_kernel_ab.py --splits           # this tree's gemv

Each tree runs in its own process (the trees' packages share a name), with
its kernels built from its own sources. A run prints one line
``AB {...}``: the device time (torch.profiler, summed kernel time over the
calls) of ``quant_matmul`` at M = 4 and 8 on gpt3_1p3b's FFN shapes (w_in
K=2048, N=8192; w_out K=8192, N=2048; int8 and int4), warm and with its
codes cold in L2 (the calls rotate over >= 100 MB of copies), and of the
fused LayerNorm at bf16 [8192, 2048], p = 0.1, training and eval.
``--splits`` times this tree's gemv route at every cluster size (the
``split`` the C entry takes) beside the skinny route on the same inputs.
The first line is the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

FFN = ((2048, 8192), (8192, 2048))


def device_ms(torch, fn, iters=40):
    """Device time of one call: kernel time summed over ``iters`` calls
    under torch.profiler. A session that recorded no kernel (the profiler
    now and then loses one) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None) == cuda)
        if us > 0:
            break
    return us / 1e3 / iters


def _weights(torch, gq, K, N, bits, dev):
    g = torch.Generator(device=dev).manual_seed(K + bits)
    w = torch.randn((K, N), generator=g, device=dev) * 0.02
    codes, step = gq.quantize_weight(w, bits, axis=-1)
    return (gq.pack_int4(codes, axis=0) if bits == 4 else codes), step, g


def run_tree(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from paddle_tpu_torch.ops.kernels import fused_residual_ln as fr
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    from paddle_tpu_torch.quantization import gpt_quant as gq
    if not Path(qm.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {qm.__file__}, not the tree {root}")
    dev = torch.device("cuda")
    res = {"tree": root}
    for bits in (8, 4):
        for K, N in FFN:
            wq, step, g = _weights(torch, gq, K, N, bits, dev)
            copies = [wq] + [wq.clone()
                             for _ in range(-(-100_000_000 // wq.numel()))]
            for M in (4, 8):
                x = torch.randn((M, K), generator=g, device=dev).bfloat16()
                key = f"qmm_b{bits}_K{K}_M{M}"
                res[key] = device_ms(
                    torch, lambda: qm.quant_matmul(x, wq, step, bits))
                turn = iter(range(1 << 40))
                res[key + "_cold"] = device_ms(
                    torch, lambda: qm.quant_matmul(
                        x, copies[next(turn) % len(copies)], step, bits),
                    iters=2 * len(copies))
            del copies
    g = torch.Generator(device=dev).manual_seed(5)
    n, d = 8192, 2048
    x = torch.randn((n, d), generator=g, device=dev).bfloat16()
    r = torch.randn((n, d), generator=g, device=dev).bfloat16()
    b, be = (torch.randn((d,), generator=g, device=dev) * 0.1
             for _ in range(2))
    ga = 1 + 0.1 * torch.randn((d,), generator=g, device=dev)
    for training in (True, False):
        res[f"ln_train{int(training)}"] = device_ms(
            torch, lambda: fr.fused_bias_dropout_residual_ln(
                x, b, r, ga, be, p=0.1, training=training, seed=7))
    return res


def run_splits() -> list[dict]:
    """gemv at every cluster size (1, 2, 4; larger ones are refused) and
    skinny, on this tree, checked against the plain version."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    from paddle_tpu_torch.quantization import gpt_quant as gq
    dev = torch.device("cuda")
    lib = qm._lib()

    def launch(x, wq, step, bits, route, split):
        M, K = x.shape
        N = wq.shape[1]
        out = torch.empty((M, N), dtype=torch.float32, device=dev)
        err = lib(x.data_ptr(), wq.data_ptr(), step.data_ptr(),
                  out.data_ptr(), M, K, N, bits, 1, 1,
                  qm.ROUTES.index(route), split,
                  torch.cuda.current_stream().cuda_stream)
        return out if err == 0 else None

    rows = []
    for bits in (8, 4):
        for K, N in FFN:
            wq, step, g = _weights(torch, gq, K, N, bits, dev)
            for M in (1, 4, 8):
                x = torch.randn((M, K), generator=g, device=dev).bfloat16()
                ref = qm.quant_matmul_ref(x, wq, step, bits)
                row = dict(K=K, N=N, bits=bits, M=M,
                           picked=qm.gemv_split(M, K, N, bits,
                                                qm._sm_count(dev)))
                row["skinny"] = device_ms(
                    torch, lambda: launch(x, wq, step, bits, "skinny", 0))
                for split in (1, 2, 4, 8):
                    out = launch(x, wq, step, bits, "gemv", split)
                    if out is None:
                        row[f"gemv{split}"] = "refused"
                        continue
                    rel = ((out - ref).abs().max() / ref.abs().max()).item()
                    if rel > 1e-4:
                        raise AssertionError(f"gemv split {split}: {rel}")
                    row[f"gemv{split}"] = device_ms(
                        torch, lambda: launch(x, wq, step, bits, "gemv",
                                              split))
                rows.append(row)
    return rows


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print("AB " + json.dumps(run_tree(argv[1])), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if argv[:1] == ["--splits"]:
        for row in run_splits():
            print("SPLIT " + json.dumps(row), flush=True)
        return 0
    for root in argv:
        root = str(Path(root).resolve())
        subprocess.run([sys.executable, __file__, "--one", root], cwd=root,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time quant_matmul's decode form, the fused bias-dropout-residual
LayerNorm and the decode attention (bf16 and scaled-int8, dense and paged)
of the PyTorch port on one NVIDIA card, for one or more trees of the
repository in turn, so that two versions are compared inside one run.

    python3 tools/torch_kernel_ab.py OLD NEW NEW OLD    # trees, in turns
    python3 tools/torch_kernel_ab.py --splits           # this tree's gemv
    python3 tools/torch_kernel_ab.py --decode-splits    # its decode split

Each tree runs in its own process (the trees' packages share a name), with
its kernels built from its own sources. A run prints one line
``AB {...}``: the device time (torch.profiler, summed kernel time over the
calls) of ``quant_matmul`` at M = 4 and 8 on gpt3_1p3b's FFN shapes (w_in
K=2048, N=8192; w_out K=8192, N=2048; int8 and int4), warm and with its
codes cold in L2 (the calls rotate over >= 100 MB of copies), and of the
fused LayerNorm at bf16 [8192, 2048], p = 0.1, training and eval, and of
``decode_attention``, ``decode_attention_paged`` (pages of 128) and their
scaled-int8 forms ``decode_attention_q8`` and ``decode_attention_paged_q8``
at B=8, H=16, d=128 over 512 and 2048 positions (Q=1; int8 also Q=4), the
rows' live lengths spread over the cache. A tree that differs from another
by one constant (a register variant) is timed against it this way.
``--splits`` times this tree's gemv route at every cluster size (the
``split`` the C entry takes) beside the skinny route on the same inputs;
``--decode-splits`` times this tree's decode kernels, bf16 and int8, dense
and paged, at every key split (nsplit 1..8) at the engine's shape (B=8,
S=512), generate()'s (B=4, S=384, every row at position 271) and S=2048
with one query row, and at S=512 and 2048 with a 4-row window, each
checked against the plain version and paged against dense bitwise. The
first line is the card's name and power limit.
"""
from __future__ import annotations

import itertools
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


def _decode_inputs(torch, da, B, S, dev, pos=None, Q=1, H=16, d=128,
                   ps=128, quant=False):
    """q, a dense cache pair (bf16, or with ``quant`` scaled-int8 (codes,
    steps) pairs), positions (spread over the cache unless given), and the
    same keys as a shuffled page pool with its table (entries past each
    row's live pages name the scratch page 0)."""
    from paddle_tpu_torch.quantization.gpt_quant import quantize_rows
    g = torch.Generator(device=dev).manual_seed(B * 7 + S)
    q = torch.randn((B, H, Q, d), generator=g, device=dev).bfloat16()
    nb = S // ps
    P = 1 + B * nb
    draw = lambda: torch.randn((P, H, ps, d), generator=g, device=dev)
    mk = (lambda: quantize_rows(draw())) if quant else \
        (lambda: draw().bfloat16())
    kp, vp = mk(), mk()
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    ptab = perm[:B * nb].reshape(B, nb).to(torch.int32)
    if pos is None:
        pos = torch.linspace(0, S - Q, B, device=dev).round()
    pos = torch.as_tensor(pos, device=dev).to(torch.int32).expand(B)
    dead = torch.arange(nb, device=dev)[None] >= ((pos.long() + Q + ps - 1)
                                                  // ps)[:, None]
    ptab = torch.where(dead, torch.zeros_like(ptab), ptab).contiguous()
    dense = lambda pool: (
        tuple(t.contiguous() for t in da.paged_view(pool, ptab)) if quant
        else da.paged_view(pool, ptab).contiguous())
    return q, dense(kp), dense(vp), pos.contiguous(), kp, vp, ptab


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
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    for S in (512, 2048):
        q, kc, vc, pos, kp, vp, ptab = _decode_inputs(torch, da, 8, S, dev)
        res[f"decode_S{S}"] = device_ms(
            torch, lambda: da.decode_attention(q, kc, vc, pos, 128 ** -0.5))
        res[f"paged_S{S}"] = device_ms(
            torch, lambda: da.decode_attention_paged(q, kp, vp, pos, ptab,
                                                     128 ** -0.5))
        for Q in (1, 4):
            q, kc, vc, pos, kp, vp, ptab = _decode_inputs(
                torch, da, 8, S, dev, Q=Q, quant=True)
            res[f"decode_q8_S{S}_Q{Q}"] = device_ms(
                torch, lambda: da.decode_attention_q8(q, kc, vc, pos,
                                                      128 ** -0.5))
            res[f"paged_q8_S{S}_Q{Q}"] = device_ms(
                torch, lambda: da.decode_attention_paged_q8(
                    q, kp, vp, pos, ptab, 128 ** -0.5))
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


def run_decode_splits() -> list[dict]:
    """This tree's decode kernels, bf16 and int8, dense and paged, at every
    key split (``da.split_keys(S, n)``, n = 1..8) on five shapes; each
    split checked against the plain version (2e-4) and paged against dense
    bitwise."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    dev = torch.device("cuda")
    scale = 128 ** -0.5
    rows = []
    for (B, S, pos, Q), quant in itertools.product(
            ((8, 512, None, 1), (4, 384, 271, 1), (8, 2048, None, 1),
             (8, 512, None, 4), (8, 2048, None, 4)), (False, True)):
        q, kc, vc, pos, kp, vp, ptab = _decode_inputs(torch, da, B, S, dev,
                                                      pos, Q, quant=quant)
        ref = da.bounded_decode_attention(q, kc, vc, pos.long(), scale, 128)
        out = torch.empty((B, 16, Q, 128), dtype=torch.float32, device=dev)
        row = dict(B=B, H=16, S=S, Q=Q, cache="int8" if quant else "bf16",
                   picked=(da.decode_split_q8 if quant
                           else da.decode_split)(B, 16, S, Q))
        for split in sorted({da.split_keys(S, n) for n in range(1, 9)}):
            dense = lambda: da._launch(q, kc, vc, pos, out, scale,
                                       split=split)
            paged = lambda: da._launch(q, kp, vp, pos, out, scale,
                                       ptab=ptab, split=split)
            dense()
            got = out.clone()
            paged()
            err = (got - ref).abs().max().item()
            if err > 2e-4 or not torch.equal(got, out):
                raise AssertionError(f"split {split}: err {err}, paged "
                                     f"bitwise {torch.equal(got, out)}")
            row[f"dense{split}"] = device_ms(torch, dense)
            row[f"paged{split}"] = device_ms(torch, paged)
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
    if argv[:1] == ["--decode-splits"]:
        for row in run_decode_splits():
            print("DSPLIT " + json.dumps(row), flush=True)
        return 0
    for root in argv:
        root = str(Path(root).resolve())
        subprocess.run([sys.executable, __file__, "--one", root], cwd=root,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # every phase, exits 0 only if all pass
    python3 chip_smoke.py --phases build,kernels

Phases, each fatal on failure:

1. build    — compile every kernel under paddle_tpu_torch/csrc with nvcc
              (one process per source, in parallel) and print the seconds
              and the ptxas register / spill report.
2. kernels  — call each kernel wrapper on the card at the main path's
              shapes and at edge shapes, hold it against its plain PyTorch
              version on the same inputs (stated tolerance), and time the
              kernel, the plain version and one PyTorch library call that
              computes the same function, beside the least time the card
              could take (bound_ms).
3. generate — gpt3_1p3b at full width (24 layers, bf16, random weights from
              a seed): generate() on B=4 x P=256 (+32 tokens) and on
              B=2 x P=200. Launch counters are zeroed just before and read
              just after; both kernels must have run.
4. server   — GenerationSession(max_slots=8, max_prompt_len=384,
              max_len=512) behind a ServingEngine replays 12 seeded
              requests, whole-prompt and with prefill_chunk=128; every
              request must end DONE with its token count, and the decode
              kernel must have run.
5. parity   — gpt3_1p3b(n_layers=2) in f32: the CPU (plain versions) and
              the card (kernels) on the same numpy weights and prompt must
              agree on prefill and 4 decode steps' logits.

The line before the last holds {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Without a CUDA device, or run from a
directory that does not hold the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "generate", "server", "parity")

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}

# the kernels against their plain versions on the card: bf16 differs by
# the bf16 rounding of the probabilities the plain version applies before
# the PV product (the kernel keeps them in f32) and of the bf16 output;
# f32 differs only by summation order (TF32 off)
TOL = {"bf16": 3e-2, "f32": 2e-4}
DECODE_TOL = {"bf16": 2e-4, "f32": 2e-4}   # decode math is f32 either way


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.rows: dict[str, dict] = {}      # kernel name -> kernels-line row

    # ----------------------------------------------------------- timing
    def time_ms(self, fn, iters=50, warmup=5) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # ------------------------------------------------------------ build
    def phase_build(self):
        from paddle_tpu_torch.ops.kernels import _build
        t0 = time.perf_counter()
        secs = _build.build()
        log(f"[build] compiled {sorted(secs)} in "
            f"{time.perf_counter() - t0:.2f} s wall "
            + json.dumps({k: round(v, 2) for k, v in secs.items()}))
        for name in _build.sources():
            for line in _build.build_log(name).splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"[build] {name}: {line.strip()}")

    # ---------------------------------------------------------- kernels
    def _flash_case(self, B, H, Sq, Skv, d, dtype, causal, with_lse,
                    time_it, main=False):
        torch = self.torch
        import torch.nn.functional as F
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        g = torch.Generator(device=self.dev).manual_seed(B * 1000 + Sq + Skv)
        mk = lambda s: torch.randn((B, H, s, d), generator=g,
                                   device=self.dev).to(dtype)
        q, k, v = mk(Sq), mk(Skv), mk(Skv)
        scale = 1.0 / d ** 0.5
        tname = "bf16" if dtype == torch.bfloat16 else "f32"
        res = fa.flash_attention(q, k, v, scale, causal, with_lse)
        torch.cuda.synchronize()
        ref = fa.xla_attention(q, k, v, scale, causal, with_lse)
        out, lse = (res if with_lse else (res, None))
        rout, rlse = (ref if with_lse else (ref, None))
        err = (out.float() - rout.float()).abs().max().item()
        if lse is not None:
            err = max(err, (lse - rlse).abs().max().item())
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError("flash_attention_fwd output not finite")
        case = dict(kernel="flash_attention_fwd", shape=[B, H, Sq, Skv, d],
                    dtype=tname, causal=causal, with_lse=with_lse,
                    max_abs_err=err, tol=TOL[tname])
        log(f"[kernels] {json.dumps(case)}")
        if err > TOL[tname]:
            raise AssertionError(f"flash_attention_fwd disagrees with its "
                                 f"plain version: {err} > {TOL[tname]}")
        if not time_it:
            return case
        offset = Skv - Sq
        pairs = sum(min(Skv, i + offset + 1) for i in range(Sq)) \
            if causal else Sq * Skv
        ops = 4 * B * H * d * pairs
        elem = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem \
            + (4 * B * H * Sq if with_lse else 0)
        t_ops = ops / PEAK_OPS[tname] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        case["ms"] = self.time_ms(
            lambda: fa.flash_attention(q, k, v, scale, causal, with_lse))
        case["plain_ms"] = self.time_ms(
            lambda: fa.xla_attention(q, k, v, scale, causal, with_lse),
            iters=10)
        if causal and Sq == Skv:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)
        else:
            rows = torch.arange(Sq, device=self.dev)[:, None]
            cols = torch.arange(Skv, device=self.dev)[None, :]
            mask = (rows + offset >= cols) if causal else None
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale)
        case["library_ms"] = self.time_ms(lib)
        case["bound_ms"] = max(t_ops, t_bytes)
        case["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[kernels] {json.dumps(case)}")
        if main:
            self.rows["flash_attention_fwd"] = case
        return case

    def _decode_case(self, B, H, S, d, Q, dtype, time_it, main=False):
        torch = self.torch
        import torch.nn.functional as F
        from paddle_tpu_torch.ops.kernels import decode_attention as da
        g = torch.Generator(device=self.dev).manual_seed(B * 100 + S + Q)
        q = torch.randn((B, H, Q, d), generator=g, device=self.dev).to(dtype)
        kc = torch.randn((B, H, S, d), generator=g, device=self.dev).to(dtype)
        vc = torch.randn((B, H, S, d), generator=g, device=self.dev).to(dtype)
        # live lengths spread over the whole cache, window inside it
        pos = torch.linspace(0, S - Q, B, device=self.dev).round().to(
            torch.int32)
        scale = 1.0 / d ** 0.5
        tname = "bf16" if dtype == torch.bfloat16 else "f32"
        out = da.decode_attention(q, kc, vc, pos, scale)
        torch.cuda.synchronize()
        ref = da.bounded_decode_attention(q, kc, vc, pos.long(), scale,
                                          min(128, S))
        err = (out - ref).abs().max().item()
        # garbage past the live length must change nothing
        kg, vg = kc.clone(), vc.clone()
        idx = torch.arange(S, device=self.dev)
        dead = idx[None, :] > (pos[:, None] + Q - 1)
        kg[dead[:, None, :, None].expand_as(kg)] = 1e4
        vg[dead[:, None, :, None].expand_as(vg)] = -1e4
        out_g = da.decode_attention(q, kg, vg, pos, scale)
        torch.cuda.synchronize()
        err_g = (out_g - out).abs().max().item()
        case = dict(kernel="decode_attention", shape=[B, H, S, d], Q=Q,
                    dtype=tname, pos=[int(p) for p in pos],
                    max_abs_err=err, garbage_delta=err_g,
                    tol=DECODE_TOL[tname])
        log(f"[kernels] {json.dumps(case)}")
        if not bool(torch.isfinite(out).all()) or err > DECODE_TOL[tname] \
                or err_g != 0.0:
            raise AssertionError(f"decode_attention disagrees with its "
                                 f"plain version: {case}")
        if not time_it:
            return case
        live = sum(min(int(p) + Q, S) for p in pos)
        elem = kc.element_size()
        nbytes = 2 * H * live * d * elem + q.numel() * elem \
            + out.numel() * 4 + B * 4
        ops = sum(4 * H * d * (int(p) + j + 1) for p in pos for j in range(Q))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["f32"] * 1e3
        case["ms"] = self.time_ms(
            lambda: da.decode_attention(q, kc, vc, pos, scale), iters=200)
        posl = pos.long()
        case["plain_ms"] = self.time_ms(
            lambda: da.bounded_decode_attention(q, kc, vc, posl, scale,
                                               min(128, S)),
            iters=20)
        qpos = pos.long()[:, None] + torch.arange(Q, device=self.dev)[None]
        mask = (idx[None, None, :] <= qpos[:, :, None])[:, None]  # B,1,Q,S
        case["library_ms"] = self.time_ms(
            lambda: F.scaled_dot_product_attention(
                q, kc, vc, attn_mask=mask, scale=scale), iters=200)
        case["bound_ms"] = max(t_ops, t_bytes)
        case["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[kernels] {json.dumps(case)}")
        if main:
            self.rows["decode_attention"] = case
        return case

    def phase_kernels(self):
        torch = self.torch
        bf16, f32 = torch.bfloat16, torch.float32
        for dt in (bf16, f32):
            self._flash_case(4, 16, 256, 256, 128, dt, True, False, True,
                             main=dt is bf16)
            self._flash_case(2, 16, 200, 200, 128, dt, True, False,
                             dt is bf16)
            for lse in (False, True):
                self._flash_case(2, 16, 128, 384, 128, dt, True, lse,
                                 dt is bf16 and not lse)
        self._flash_case(1, 2, 70, 70, 16, f32, False, True, False)
        self._flash_case(1, 2, 33, 97, 64, bf16, True, True, False)
        for dt in (bf16, f32):
            for Q in (1, 4):
                self._decode_case(8, 16, 2048, 128, Q, dt, dt is bf16)
        # the server phase's decode shape: 8 slots, 512-position cache
        self._decode_case(8, 16, 512, 128, 1, bf16, True, main=True)
        self._decode_case(3, 4, 64, 16, 3, f32, False)

    # ------------------------------------------------------ main path
    def _counters(self):
        from paddle_tpu_torch.ops.kernels.decode_attention import (
            decode_attention)
        from paddle_tpu_torch.ops.kernels.flash_attention import (
            flash_attention)
        return {"flash_attention_fwd": flash_attention,
                "decode_attention": decode_attention}

    def _zero_counts(self):
        for fn in self._counters().values():
            fn.launches = 0

    def _read_counts(self, path: str, need) -> dict:
        """Counts of one main-path run; every kernel in ``need`` must have
        launched, and the counts add to the kernels line."""
        counts = {n: fn.launches for n, fn in self._counters().items()}
        log(f"[{path}] kernel launches {json.dumps(counts)}")
        for n in need:
            if counts[n] <= 0:
                raise AssertionError(f"{path}: kernel {n} never launched")
        for n, c in counts.items():
            row = self.rows.setdefault(n, {})
            row["launches"] = row.get("launches", 0) + c
        return counts

    def _model(self):
        if getattr(self, "params", None) is None:
            from paddle_tpu_torch.models import gpt
            self.cfg = gpt.gpt3_1p3b()
            t0 = time.perf_counter()
            self.params = gpt.init_params(self.cfg, seed=0, device=self.dev)
            self.torch.cuda.synchronize()
            n = sum(t.numel() for t in self.params["blocks"].values()) \
                + self.params["wte"].numel() + self.params["wpe"].numel()
            log(f"[model] gpt3_1p3b: {n / 1e9:.3f} B params bf16, random "
                f"weights (seed 0) in {time.perf_counter() - t0:.1f} s")
        return self.cfg, self.params

    def phase_generate(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        cfg, params = self._model()
        rng = np.random.default_rng(0)
        cases = [(4, 256, 32), (2, 200, 32)]
        prompts = [rng.integers(0, cfg.vocab_size, (B, P)) for B, P, _ in
                   cases]
        # warm-up outside the counted window: cuBLAS handles, allocator
        gpt.generate(params, cfg, prompts[1][:, :16], 2, device=self.dev)
        torch.cuda.synchronize()
        self._zero_counts()
        for (B, P, N), prompt in zip(cases, prompts):
            kc, vc = gpt.init_kv_cache(cfg, B, gpt.pad_cache_len(
                P + N, cfg.decode_block), device=self.dev)
            logits, _, _ = gpt.prefill(params, cfg, torch.as_tensor(
                prompt, device=self.dev), kc, vc)
            if not bool(torch.isfinite(logits).all()) \
                    or logits.shape != (B, cfg.vocab_size):
                raise AssertionError("prefill logits not finite / misshaped")
            t = []
            for n in (1, N):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = gpt.generate(params, cfg, prompt, n, device=self.dev)
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            if out.shape != (B, P + N) or not bool(
                    ((out >= 0) & (out < cfg.vocab_size)).all()):
                raise AssertionError(f"generate output bad: {out.shape}")
            ms_tok = (t[1] - t[0]) / (N - 1) * 1e3
            log("[generate] " + json.dumps(dict(
                batch=B, prompt=P, new_tokens=N,
                prefill_ms=round(t[0] * 1e3, 3),
                decode_ms_per_token=round(ms_tok, 3),
                decode_tokens_per_s=round(B / ms_tok * 1e3, 1),
                total_s=round(t[1], 3))))
        self._read_counts("generate", ("flash_attention_fwd",
                                       "decode_attention"))
        self._profile(cfg, params, prompts[0])

    def _profile(self, cfg, params, prompt):
        """Where the time of the main path goes: torch.profiler over one
        B=4 x P=256 prefill and over 16 decode steps, printing the wall
        time with and without the profiler, the summed device time (one
        stream, so device time over unprofiled wall is the busy share)
        and the kernels that take the most device time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch.models import gpt
        B, P = prompt.shape
        tokens = torch.as_tensor(prompt, device=self.dev)
        kc, vc = gpt.init_kv_cache(cfg, B, 384, device=self.dev)

        def prefill():
            return gpt.prefill(params, cfg, tokens, kc, vc)[0]

        def decode(steps=16):
            tok = tokens[:, -1]
            for i in range(steps):
                logits, _, _ = gpt.decode_one_token(params, cfg, tok, P + i,
                                                    kc, vc)
                tok = logits.argmax(-1)

        for name, fn in (("prefill", prefill), ("decode_x16", decode)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            dev_us = lambda e: getattr(e, "self_device_time_total",
                                       getattr(e, "self_cuda_time_total", 0))
            # kernel rows only: an operator row repeats its kernels' time
            cuda = torch.autograd.DeviceType.CUDA
            rows = [e for e in prof.key_averages()
                    if getattr(e, "device_type", None) == cuda
                    and dev_us(e) > 0]
            busy_ms = sum(dev_us(e) for e in rows) / 1e3
            top = sorted(rows, key=dev_us, reverse=True)[:8]
            log("[profile] " + json.dumps(dict(
                region=name, batch=B, prompt=P,
                wall_ms_unprofiled=round(plain_ms, 3),
                wall_ms_profiled=round(wall_ms, 3),
                device_busy_ms=round(busy_ms, 3),
                # against the unprofiled wall: the profiler slows the host
                device_idle_share=round(1 - busy_ms / plain_ms, 4)
                if busy_ms else None,
                top=[dict(name=e.key[:60], ms=round(dev_us(e) / 1e3, 3),
                          calls=e.count) for e in top])))

    def phase_server(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.inference import GenerationSession
        from paddle_tpu_torch.serving import RequestState, ServingEngine
        cfg, params = self._model()
        sess = GenerationSession(params, cfg, max_slots=8,
                                 max_prompt_len=384, max_len=512,
                                 device=self.dev)
        rng = np.random.default_rng(1)
        trace = [(rng.integers(0, cfg.vocab_size, (int(n),)), int(m))
                 for n, m in zip(rng.integers(64, 385, 12),
                                 rng.integers(16, 65, 12))]
        outputs = {}
        for chunk in (0, 128):
            eng = ServingEngine(sess, max_queue=64, prefill_chunk=chunk,
                                device=self.dev)
            warm = eng.submit(trace[0][0][:64], max_new_tokens=2)
            eng.run()
            if warm.state is not RequestState.DONE:
                raise AssertionError("warm-up request did not finish")
            sess.reset_metrics()
            self._zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [eng.submit(p, max_new_tokens=m) for p, m in trace]
            ticks = eng.run(deadline=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for r, (_, m) in zip(reqs, trace):
                if r.state is not RequestState.DONE or len(r.output) != m:
                    raise AssertionError(
                        f"{r.request_id}: {r.state} with {len(r.output)} of "
                        f"{m} tokens")
            met = eng.metrics()
            toks = sum(len(r.output) for r in reqs)
            log("[server] " + json.dumps(dict(
                prefill_chunk=chunk, requests=len(reqs), ticks=ticks,
                prompt_tokens=int(sum(len(p) for p, _ in trace)),
                new_tokens=toks, wall_s=round(wall, 3),
                tokens_per_s=round(toks / wall, 1),
                ttft_ms_p50=met["ttft_ms_p50"], ttft_ms_p99=met["ttft_ms_p99"],
                decode_ms_per_token_p50=met["decode_ms_per_token_p50"])))
            self._read_counts(f"server(prefill_chunk={chunk})",
                              ("decode_attention",))
            outputs[chunk] = [r.output for r in reqs]
            eng.close()
        same = sum(a == b for a, b in zip(outputs[0], outputs[128]))
        log(f"[server] whole-prompt and chunked streams identical for "
            f"{same}/{len(trace)} requests (bf16: the two prefill paths "
            "round differently)")

    def phase_parity(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        # f32 on both sides with TF32 off; the tolerance covers summation
        # order over 2048-wide products and the two attention paths
        tol = 1e-3
        cfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32)
        prompt = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                   (2, 100))
        sides = {}
        for dev in ("cpu", self.dev):
            params = gpt.init_params(cfg, seed=0, device=dev)
            kc, vc = gpt.init_kv_cache(cfg, 2, 128, device=dev)
            logits, kc, vc = gpt.prefill(params, cfg, torch.as_tensor(
                prompt, device=dev), kc, vc)
            sides[str(dev)] = [logits.cpu()]
            sides[str(dev) + "_state"] = (params, kc, vc)
        toks = sides["cpu"][0].argmax(-1)
        for step in range(4):
            for dev in ("cpu", self.dev):
                params, kc, vc = sides[str(dev) + "_state"]
                logits, _, _ = gpt.decode_one_token(
                    params, cfg, toks.to(dev), 100 + step, kc, vc)
                sides[str(dev)].append(logits.cpu())
            toks = sides["cpu"][-1].argmax(-1)
        errs = [(c - g).abs().max().item()
                for c, g in zip(sides["cpu"], sides[str(self.dev)])]
        agree = float(np.mean([bool((c.argmax(-1) == g.argmax(-1)).all())
                               for c, g in zip(sides["cpu"],
                                               sides[str(self.dev)])]))
        log("[parity] " + json.dumps(dict(
            config="gpt3_1p3b(n_layers=2, f32)", prompt=[2, 100],
            max_abs_err_prefill=errs[0], max_abs_err_decode=max(errs[1:]),
            tol=tol, greedy_agreement=agree)))
        if max(errs) > tol or agree < 1.0:
            raise AssertionError(f"CPU and card disagree: {errs}, {agree}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: paddle_tpu_torch/ is not beside this script — "
              "run it from the repository root", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    torch.manual_seed(0)
    np.random.seed(0)
    # f32 comparisons are against full-f32 products, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    smoke = Smoke(torch)
    t_all = time.perf_counter()
    for p in phases:
        t0 = time.perf_counter()
        getattr(smoke, f"phase_{p}")()
        log(f"[{p}] passed in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for name, src, rep in (
            ("flash_attention_fwd", "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:55"),
            ("decode_attention", "paddle_tpu_torch/csrc/decode_attention.cu",
             "paddle_tpu/ops/pallas/decode_attention.py:217")):
        row = dict(smoke.rows.get(name, {}))
        row.update(name=name, route="cuda", source=src, replaces=rep)
        row.setdefault("launches", 0)
        kernels.append({k: row.get(k) for k in keys})
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

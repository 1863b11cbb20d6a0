#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # every phase, exits 0 only if all pass
    python3 chip_smoke.py --phases build,kernels,train,train_parity
    python3 chip_smoke.py --phases build,kernels,paged,paged_parity
    python3 chip_smoke.py --phases build,incubate,sampling
    python3 chip_smoke.py --phases build,spec
    python3 chip_smoke.py --phases build,graph
    python3 chip_smoke.py --phases build,buckets
    python3 chip_smoke.py --phases build,resil,fleet
    python3 chip_smoke.py --phases build,moe,moe_parity,guards
    python3 chip_smoke.py --phases build,eager,eager_parity
    python3 chip_smoke.py --phases build,kernels,amp,jit,hapi

Phases, each fatal on failure:

1. build    — compile every kernel under paddle_tpu_torch/csrc with nvcc
              (one process per source, in parallel) and print the seconds
              and the ptxas register / spill report. (The two Triton
              kernels compile at their first launch.)
2. kernels  — call each kernel wrapper on the card at the main path's
              shapes and at edge shapes, hold it against its plain PyTorch
              version on the same inputs (stated tolerance; the flash
              forward's and backward's route by dtype, wgmma for bf16,
              CUDA-core for f32, with TFLOP/s and share of the bound;
              quant_matmul's route by shape, gemv, skinny, wgmma or wmma,
              printed in every case, each case also bitwise against a second
              launch, the decode form timed with its weights cold in L2 as
              well; the paged
              decode kernels also bitwise against the dense ones over the
              gathered view, and every decode kernel bitwise against a
              second launch, each printing its split (nsplit, chunk);
              the fused bias-dropout-residual LayerNorm at
              [8192, 2048] and edge shapes, its route (warp or block)
              printed, bitwise against a second launch; the decode
              attention kernels' device time beside their CUDA-event time
              and SDPA's device time;
              the Triton factories on ReLU,
              a*b+1, sum and max at 2^24 f32, ragged and empty), and time the
              kernel, the plain version and one PyTorch library call that
              computes the same function, beside the least time the card
              could take (bound_ms).
3. generate — gpt3_1p3b at full width (24 layers, bf16, the reference's
              init_params draw from seed 0): generate() on B=4 x P=256 (+32 tokens) and on
              B=2 x P=200. Launch counters are zeroed just before and read
              just after; both serving kernels must have run.
4. server   — GenerationSession(max_slots=8, max_prompt_len=384,
              max_len=512) behind a ServingEngine replays 12 seeded
              requests, whole-prompt and with prefill_chunk=128 (no width
              buckets: every chunk tick runs at the one width, its graphs
              captured by prewarm() before the warm-up request); every
              request must end DONE with its token count, and the decode
              kernel must have run.
5. parity   — gpt3_1p3b(n_layers=2) in f32: the CPU (plain versions) and
              the card (kernels) on the same numpy weights and prompt must
              agree on prefill and 4 decode steps' logits.
6. quant    — quantized serving at full gpt3_1p3b width: the seed-0 bf16
              tree quantized on the card by quantize_gpt_params, w8kv8
              then w4kv8 (int8/int4 FFN and lm-head weights, scaled-int8
              KV cache): generate() on B=4 x P=256 (+32 tokens) and the
              server's 12-request replay (w8kv8 whole-prompt and
              prefill_chunk=128, w4kv8 whole-prompt). Launch counts are
              checked exactly: 48 quant_matmul a forward (prefill, suffix
              chunk or decode tick; generate()'s prefills on the wgmma
              route and its decode ticks on gemv, exactly; the replays' decode
              ticks on gemv and none on skinny), 24 flash forwards a
              whole-prompt prefill, 24 decode_attention_q8 a decode tick, no
              fp decode attention. Prints the quant byte accounting, a w8kv8 profile
              of a prefill and 16 decode ticks and, as information, the top-1
              agreement and largest logit difference against the bf16
              model on one prefill.
7. quant_parity — gpt3_1p3b(n_layers=2, f32) in w8kv8 and w4kv8: the CPU
              and the card quantize the same numpy weights to equal codes
              and agree on prefill and 4 decode steps' logits (1e-3) with
              identical greedy tokens; every card launch of quant_matmul
              (f32 x) on the skinny route.
8. paged    — paged KV serving at full gpt3_1p3b width (bf16, page size =
              decode_block = 128, 8 slots x 512 positions): the server's
              12-request replay on a paged session (33 pages) and on a dense
              one, whole-prompt and prefill_chunk=128, with equal streams;
              the replay on half the dense pool's bytes (kv_pages=17), every
              request DONE, with the peak of admitted rows and the page
              backpressure; a 12-request shared-prefix trace (256-token
              prefix) paged and dense, with prefix_cache_blocks=16 and
              without (paged and dense streams equal with reuse); the replay
              in w8kv8 on a paged session. Launch counts checked exactly
              against the session's tick and chunk counters: 24 paged
              decode attention (fp or int8) a tick, 48 quant_matmul a w8kv8
              forward, no dense decode attention in a paged run. A profile
              of 16 paged decode ticks beside 16 dense ones.
9. paged_parity — gpt3_1p3b(n_layers=2, f32): a paged session's prefill
              and 4 decode steps on the CPU (plain versions) and on the card
              (kernels) from the same numpy weights, within 1e-4 (w8kv8:
              1e-3) with identical greedy tokens, and the same on the
              reference's init_params draw as information; on the card, a
              shared-prefix replay gives the same greedy streams with
              reuse on and off.
10. train   — gpt3_1p3b(remat=True, fused_adamw=True, xent_chunks=4) at
              full width trains on one seeded B=4 x S=2048 batch: a warm-up
              step, then 5 timed steps with the launch counters zeroed just
              before and read just after (flash forward, both backward
              kernels and fused AdamW must have run); every loss finite and
              the last below the first; one profiled step; then the eval
              step and generate() on the trained params.
11. train_parity — gpt3_1p3b(n_layers=2, f32, fused_adamw, remat,
              xent_chunks=2), B=2 x S=256, 3 steps on the CPU (plain
              versions) and on the card (kernels) from the same numpy
              weights: losses within 1e-4, params within the AdamW
              tolerance.
12. incubate — incubate.nn.FusedBiasDropoutResidualLayerNorm(2048, p=0.1)
              on [4, 2048, 2048] bf16: 3 training forward+backward steps,
              each with a grad-norm monitor built from the primitive
              factories (square, sum), then an eval forward, counted exactly
              (one fused launch a forward); masks fresh each step and equal
              after seed() again; gradients equal autograd through the plain
              version; a [64, 256] f32 cut and the dropout hash equal on the
              CPU and the card.
13. sampling — the threefry known answers on the card; bits, uniform and
              normal over [4, 50304] bitwise equal on the card and the
              CPU, and so is one full-width init_params layer; one
              categorical's kernel launches and time; full-width generate()
              B=4 x P=256 (+32), greedy beside sampled (temperature 0.8, top-k
              50, seed 0), ms a token each, exact launch counts; the 12-request
              replay sampled; 2-layer f32 sampled streams equal on the CPU and
              the card.
14. spec    — speculative decoding (spec_decode=4). Full width, bf16, on
              a fresh init_params draw from seed 0 (the train phase trains
              the shared weights in place): a
              session with the early-exit draft (the first 12 layers) over
              B=4 x P=256 (+32) beside spec off: ms a token each, the
              acceptance rate and tokens a row a tick, exact decode-attention
              launches by window width a tick (3 x 12 at Q=1 and 24 at Q=4),
              the margin rule (spec-on greedy streams equal spec-off ones, or
              the first differing token's spec-off top-two logit gap is no
              larger than d, the largest difference between the two logits
              rows that produced it; d over every shared token and e, each
              kernel-path row against the same forward through the plain
              decode attention, stay within their limits), and profiles of
              16 ticks each, spec off and spec on, the latter with the
              verify's Q=4 device time. The kernels phase holds the decode
              kernels and quant_matmul at this phase's shapes (a guard
              fails if a session's cache length moves). The 12-request
              replay through
              ServingEngine(prefill_chunk=128): dense bf16 with a separate
              draft (the first 4 layers as a model of their own) and half the
              requests sampled at temperature 0.8 with their own seeds; w8kv8
              on a paged pool with the early-exit draft, then 16 of its spec
              ticks profiled at B=8; every request DONE, launches and
              quant_matmul routes exact (the draft's steps on gemv, the
              verify and the chunks on wgmma). 2 layers f32 on the
              CPU and the card: greedy spec streams (early-exit and separate
              draft, dense and paged) equal spec off and equal across the
              two; sampled spec streams and the lane's per-row key draws over
              [4, 50304] equal bitwise across the two.
15. graph   — the serving steps as captured CUDA graphs, at full gpt3_1p3b
              width (bf16, init_params seed 0, and its w8kv8 quantization):
              two identical sessions side by side, one under eager_ticks(),
              fed the same admissions (two rows of 256 tokens, two more
              after six ticks), 16 ticks each: plain greedy and sampled,
              dense and paged, bf16 and w8kv8; spec k=4 with the early-exit
              and a separate draft (the first 4 layers), greedy and
              stochastic. Every tick's tokens, the final logits, tick
              state and caches bitwise equal. generate() B=4 x P=256 (+32)
              greedy and sampled, graphed against eager, bitwise equal,
              ms a token each. 16 plain ticks (bf16 and w8kv8) and 16 spec
              ticks (bf16, k=4) at B=4, eager beside graphed: wall, device
              time (profiler, and 16 bare replays between CUDA events),
              idle share; 16 graphed ticks make one copy call each (the
              host's cudaMemcpyAsync calls in the range: the tokens, device
              to host) and no host-to-device copy.

16. buckets — width buckets and prefill batching at full gpt3_1p3b width
              (bf16, init_params seed 0, 8 slots x 512 positions): four
              replays, each on a graphed session after prewarm() (one in
              the background) beside an identical session under
              eager_ticks(), streams, tick state and caches bitwise equal:
              the 12-request replay with prefill_chunk=128,
              width_buckets=(32, 64), prefill_min_batch=6,
              prefill_max_defer=4; the same whole-prompt with
              width_buckets=(64, 128, 256); the shared-prefix trace on a
              paged session with prefix_cache_blocks=16, width_buckets=(32,
              64, 128); the w8kv8 paged early-exit spec replay (k=4,
              prefill_chunk=128, width_buckets=(32, 64)). Per replay: TTFT
              p50/p99, tokens/s (PR 12's beside them), wall of a tick by
              kind and width, exact launch counts, the graphs prewarm()
              captured (the replay captures none) and their pool MiB; then
              four requests profiled: device time a tick by kind and
              width, and every tick's host-to-device copies exactly what
              it owes (a chunk tick its packed batch, any tick the page
              tables or a decode tick the dump positions when they
              changed), one device-to-host copy each.

17. resil   — the serving resilience, metering and tracing planes at full
              gpt3_1p3b width (bf16, 8 slots x 512 positions), on the
              12-request replay with prefill_chunk=128, width_buckets=(32,
              64), prefill_min_batch=6, prefill_max_defer=4, one prewarmed
              session: plain; under ResiliencePolicy() with no fault; with
              metering=True and a tenant on every request (the meter's
              decode tokens equal tokens_emitted); with
              PADDLE_TPU_TRACING=1; all three at once. Each run's streams,
              tick sequence (kind and width), polls and captured graphs
              equal the plain run's; tokens/s and TTFT p50/p99 of each.
              Then a child process (this script, --resil-child) replays
              the same trace on the same weights with the crash journal
              and PADDLE_TPU_CHAOS=kill@tick=N, N half the replay's polls:
              its return code must be -9; replay_journal on a fresh engine
              here ends every journaled request DONE, each stream equal
              to the uninterrupted run's, or parted where the margin rule
              explains it (_streams_check: at the first differing token
              the top-two gap is within d, the difference between a
              decode-written and a prefill-written context, and d within
              SPEC_D_LIMIT, with the GEMM kernels of both printed).
18. fleet   — two replicas on one card sharing one set of weights, each
              with its own session, caches and graph pool: prefix
              affinity against round-robin on a three-group shared-prefix
              trace (256-token system prompts, in rounds), hit tokens of
              each; prefill/decode disaggregation (a paged prefill replica
              whose handoffs materialize device tensors, a dense decode
              replica) against a monolithic engine on the 12-request
              replay: streams (the margin rule as in resil), TTFT,
              tokens/s, handoff bytes and ms; a replica killed after 4
              polls and recovered from its journal: no request lost,
              streams as before. Train also runs remat_policy "dots"
              beside "full" (bitwise equal, step ms, peak), and generate
              the scan prefill mode beside full (B=2 x P=64 +16).
19. moe     — gpt3_1p3b(moe_experts=8, moe_top_k=2, moe_capacity_factor=
              2.0) at full width (6.95 B params, bf16, init_params seed 0):
              a warm-up and 3 timed train steps on one seeded B=4 x S=2048
              batch (remat, xent_chunks=4, bf16 moments: the plain AdamW,
              in place; alltoall dispatch), flash launches exact, the aux
              term, peak memory, the eval step; generate() B=4 x P=256
              (+32) graphed and under eager_ticks(), bitwise equal, 24
              decode launches a tick; the 12-request replay paged at
              prefill_chunk=128, every request DONE, launches exact; w8kv8
              generate() with 2 E quant_matmul launches a layer a forward
              (wgmma at prefill, gemv at decode); the device time of one
              decode tick and one W=128 chunk tick (8 rows) of the MoE
              model, bf16 and w8kv8, beside the dense model's.
20. moe_parity — gpt3_1p3b(n_layers=2, f32, moe_experts=8) on the same
              numpy weights, the CPU (plain versions) against the card
              (kernels): 3 train steps in each dispatch mode (losses within
              1e-4); prefill and 4 decode steps in f32 (logits within 1e-3)
              and w8kv8 (codes equal; logits within 2e-3; printed beside
              it, the CPU's own spread on ulp-perturbed embeddings and two
              injected faults, which must exceed the limit); greedy tokens
              identical.
21. guards  — the anomaly sentinel on gpt3_1p3b(remat, fused AdamW,
              xent_chunks=4) at full width: 4 healthy guarded steps bitwise
              equal to 4 unguarded ones from copies of the same state (the
              last 3 of each timed side by side), then nan_grad and inf_grad (the
              chaos plan's corrupted value in the first positional
              embedding) and spike_loss (through loss_cap) steps, each with
              its code and params and moments bitwise untouched, fused
              AdamW launched on applied steps only; run_guarded with a
              CheckpointManager under $TMPDIR on gpt3_1p3b(n_layers=4):
              two poisoned steps roll back to the last commit and are
              quarantined (in the checkpoint aux too), the losses equal a
              clean run that skips them, bit for bit; save and restore
              seconds and bytes; a trainer child (--guards-child) run
              whole, beside it another SIGKILLed after its first commit,
              then a third resumed from that commit: the resumed losses
              equal the whole run's.

22. eager   — the eager framework surface (``import paddle_tpu_torch as
              paddle``: Tensor on torch autograd, nn.Layer, the optimizers)
              on the card. LeNet after seed(0): 50 Adam steps at B=64 on
              synthetic 1x28x28 digits (numpy, one recipe a class, from a
              seed here), the loss must fall; steps/s and the final
              training accuracy. The eager GPT at gpt3_1p3b width in f32
              (24 layers, d 2048, 16 heads, vocab 50304, dropout 0): its
              weights set from the functional face's init_params draw
              (models.gpt.eager_state_dict), its logits held against the
              functional forward's (1e-3); then 3 AdamW steps on one B=1 x
              S=2048 batch with the counters zeroed just before and read
              just after: exactly 24 flash forwards, 24 dq and 24 dk/dv a
              step (the f32 CUDA-core routes), the loss falls; step ms,
              tokens/s, max_memory_allocated.
23. eager_parity — gpt3_1p3b(n_layers=2, f32) as the eager GPT and LeNet on
              the CPU and on the card from the same numpy weights: the
              losses of 3 steps (AdamW, Adam) within 1e-4, the card's
              flash launches exact; one Dropout(0.1) call's mask bitwise
              equal on the two after seed().

24. amp     — mixed precision on the eager GPT at gpt3_1p3b width (24
              layers, init_params seed 0 through eager_state_dict, the
              eager phase's B=1 x S=2048 batch, AdamW(3e-5)): 3 steps
              under auto_cast O1 bf16 and with decorate(level="O2",
              master_weight=True) bf16, beside the eager phase's f32 run
              (run here when it did not); the losses within
              AMP_LOSS_VS_F32[level] of f32's; step ms, tokens/s, peak
              memory; flash launches exactly 24 + 24 + 24 a step, all on
              the wgmma route. Planted faults at that size (AMP_FAULTS:
              cross_entropy and layer_norm forced to bf16, an amp_cast
              whose gradient is dropped) read beside each limit, which
              must see those in AMP_MUST_SEE. O1 float16 with
              GradScaler() at its defaults for 6 steps (the scale and
              found_inf each step, at least one applied), then 2 steps on
              the same moments under a scaler from 2^40: every f16
              gradient overflows, and each skipped step's parameters and
              moments are bitwise those of its start. The operator stats
              of one O1 step by dtype. The f16 kernels (forward, dq,
              dk/dv) against their plain versions at [1,16,2048,2048,128]
              causal and at ragged shapes (TOL["f16"], BWD_TOL["f16"]),
              timed beside SDPA f16, and bf16 at that shape beside SDPA
              bf16. The 2-layer f32-weight cut under O1 bf16, the CPU
              against the card, losses within AMP_CUT_LOSS_TOL, which
              must see the card's planted faults in AMP_MUST_SEE["cut"].
25. jit     — LeNet: 20 eager Adam steps, then 20 under to_static
              (inductor, full graph), losses within JIT_LENET_TOL of an
              eager twin from the same state, one compile. jit.save of
              the O2 bf16 GPT with InputSpec([1, 2048], "int64"), served
              through jit.load and inference.create_predictor(Config(
              path)): logits within JIT_EXPORT_TOL of the eager layer, 24
              flash forwards a call, ms a call beside the eager layer's
              (the predictor's handle form, its outputs on the card; its
              list form with the logits' copy to the host beside it), the
              host's time to enqueue a call, device time, the file sizes.
              to_static(GPT(gpt3_1p3b)) under O1 bf16 for 3 steps: one
              compile (its seconds, by torch's timers), no graph break
              (fullgraph), flash launches exact, losses within
              JIT_GPT_TOL of the amp phase's eager O1 losses, step ms
              beside the eager one; then the exported forms served again
              in the same process. jit.save of LeNet served by the
              predictor equals the eager forward (1e-5).
26. hapi    — paddle.Model(LeNet()).prepare(Adam(1e-3),
              CrossEntropyLoss(), Accuracy()).fit on MNIST(mode="train")
              (the synthetic digits), batch 64, with EarlyStopping and
              ModelCheckpoint into a temporary directory: 1 epoch with
              no workers, 2 epochs with num_workers=2 (thread workers:
              CUDA is up); steps/s of each; evaluate on MNIST(mode="test")
              must reach HAPI_MIN_ACC (the reference's synthetic digits
              are faint: see the constant).

Every other phase runs the session's ticks and generate()'s steps as
captured graphs too (each session's first tick is the warm-up, run
eagerly; the second captures; later ticks replay). The kernel counters
count what the device ran: a replay adds the launches its capture
recorded. The spec phase's margin rule runs its ticks eagerly
(eager_ticks()): it reruns each forward through the plain attention.

The CPU/card parity gates (parity, quant_parity, paged_parity,
train_parity, sampling's 2-layer streams) run on the numpy N(0, 0.02)
weights from seed 0 they were calibrated on; every full-width phase runs
on init_params, the reference's draw.

The line before the last holds {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Without a CUDA device, or run from a
directory that does not hold the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "generate", "server", "parity", "quant",
          "quant_parity", "paged", "paged_parity", "train", "train_parity",
          "incubate", "sampling", "spec", "graph", "buckets", "resil",
          "fleet", "moe", "moe_parity", "guards", "eager", "eager_parity",
          "amp", "jit", "hapi")

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12}

# the kernels against their plain versions on the card: bf16 differs by
# the bf16 rounding of the probabilities the plain version applies before
# the PV product (the kernel keeps them in f32) and of the bf16 output;
# f32 differs only by summation order (TF32 off)
# f16 has 3 more mantissa bits than bf16 (2^-11 against 2^-8 a rounding),
# so its limits are bf16's over 8
TOL = {"bf16": 3e-2, "f16": 4e-3, "f32": 2e-4}
DECODE_TOL = {"bf16": 2e-4, "f32": 2e-4}   # decode math is f32 either way
# flash backward against its plain version, relative to max|grad|: in bf16
# the wgmma kernels round p and ds to bf16 before the three products that
# consume them, the plain version only p before p^T dO, and both round dq,
# dk, dv to bf16 (tests/test_torch_train_kernels_cpu.py models the kernels'
# rounding on the CPU); in f32 (CUDA-core kernels) only the summation order
# differs
BWD_TOL = {"bf16": 2 ** -6, "f16": 2 ** -9, "f32": 1e-4}
# fused AdamW against its plain version: f32 moments to a few f32 roundings
# (the kernel may fuse multiply-adds) relative to max|m|, max|v|; a bf16 p
# elementwise to one bf16 rounding of the f32 result, relative to |p| plus
# a floor of 1e-5 of the leaf's largest |p|: where p and lr * update nearly
# cancel, the two f32 results differ by an f32 rounding of p, which is
# large against the tiny difference itself
ADAMW_MOMENT_TOL = 1e-5
ADAMW_BF16_REL = 2 ** -7
ADAMW_CANCEL_FLOOR = 1e-5
# quant_matmul against its plain version, relative to max|out|: the
# products are exact in f32 (integer codes times bf16 or f32 x), so only
# the summation order differs
QMM_TOL = 1e-4
# the spec phase's margin rule at full width, bf16, in logit units: d, a
# spec-on verify row against the spec-off row of the same position (both
# kernel paths), and e, a kernel-path logits row against the same forward
# through the plain decode attention. Readings on an H100 (PERF.md §6):
# d <= 0.0601 and e <= 0.0606 (about two bf16 ulps of logits near 4);
# a verify window attending one key short gives e 0.103-0.164 in every
# row and d 0.107-0.150 in three of four
SPEC_D_LIMIT = 0.09
SPEC_E_LIMIT = 0.09
# quantized logits, CPU against the card: K/V codes come from activations
# that differ by summation-order ulps, which can move a code across a
# rounding tie by one step
QUANT_PARITY_TOL = 1e-3
# the moe_parity phase's w8kv8 logits, CPU against the card: the 8-expert
# cut's K/V codes cross rounding ties where dense's do not. Readings on an
# H100 (PERF.md section 6): a sound card 1.26e-3; the CPU forward on
# positional embeddings scaled by (1 + 1e-7 N(0, 1)), a perturbation of
# the size of the card's other summation order, 0.94e-3; two faults in
# the same CPU forward (experts 0 and 1 swapped; expert 0's output
# dropped) move the prefill logits by 5.07 and 0.143, and the phase fails
# if either stays within the limit
MOE_QUANT_PARITY_TOL = 2e-3
MOE_QUANT_NOISE_REL = 1e-7
# the resil phase's engine: the buckets phase's chunk=128 replay (the
# reference's serving runs use min batch 6, defer 4)
RESIL_ENGINE = dict(prefill_chunk=128, width_buckets=(32, 64),
                    prefill_min_batch=6, prefill_max_defer=4)
# the fleet phase's replicas: chunked prefill with prefix reuse on blocks of
# decode_block = 128 tokens; a replica dies after this many fleet polls
FLEET_ENGINE = dict(prefill_chunk=128, width_buckets=(32, 64),
                    prefix_cache_blocks=16)
FLEET_KILL_AFTER_POLLS = 4
# fused bias-dropout-residual LayerNorm against its plain version, relative
# to max(|plain|, 1): the same f32 math in another summation order, so one
# bf16 step of the output (2^-7) in bf16 and 1e-5 in f32; one dropout mask
# bit off would be an O(1) error
FLN_TOL = {"bf16": 2 ** -7, "f32": 1e-5}
# the amp phase's bf16 losses against f32 on the same weights and batch,
# max over 3 AdamW steps at lr 3e-5, one limit a level, a few times its
# sound reading (NVIDIA H100 80GB HBM3, 700.00 W; the losses repeat bit
# for bit from run to run): O1 4.85e-4 (only the white-list inputs round
# to bf16), O2 0.0431 (every weight and activation outside the black list
# in bf16). Planted faults read at this size (AMP_FAULTS): O1 sees
# cross_entropy in bf16 (0.028) and a dropped amp_cast gradient (1.59);
# O2 sees the dropped gradient (1.59), while cross_entropy in bf16 (0.063)
# lies inside O2's own bf16 spread; layer_norm in bf16 moves neither
# (5.0e-4, 0.0431: its output feeds white-list ops, rounded to bf16 anyway)
AMP_LOSS_VS_F32 = {"O1": 2e-3, "O2": 0.1}
# the 2-layer f32-weight cut under O1 bf16, the CPU against the card: both
# round the same white-list inputs to bf16 and sum in f32 in different
# orders (and the card's flash kernel keeps p in f32); sound reading
# 3.59e-4; on the card cross_entropy in bf16 reads 3.50e-3, layer_norm in
# bf16 5.5e-4
AMP_CUT_LOSS_TOL = 1.5e-3
# the planted faults the amp phase reads (name -> auto_cast's custom white
# list, or None for an amp_cast whose gradient is dropped)
AMP_FAULTS = {"cross_entropy in bf16": {"cross_entropy"},
              "layer_norm in bf16": {"layer_norm"},
              "amp_cast without gradient": None}
# the faults each limit must see (the phase fails if one lies inside)
AMP_MUST_SEE = {"O1": ("cross_entropy in bf16", "amp_cast without gradient"),
                "O2": ("amp_cast without gradient",),
                "cut": ("cross_entropy in bf16",)}
# to_static LeNet (inductor) against its eager twin over 20 Adam steps in
# f32 (TF32 off): inductor fuses and reorders reductions, a few f32 ulps
# a step that Adam carries on
JIT_LENET_TOL = 1e-4
# to_static GPT under O1 bf16 against the eager O1 losses: inductor fuses
# the bf16 casts and reorders the f32 reductions around them
JIT_GPT_TOL = 2e-2
# the exported O2 bf16 GPT (jit.load and the predictor) against the eager
# layer: the same ATen ops on the same bf16 weights; relative to max|logit|
JIT_EXPORT_TOL = 1e-2
# the hapi phase's LeNet on MNIST's synthetic digits after 2 epochs. The
# reference's recipe adds its noise to the 255-valued class blob in uint8,
# which wraps the blob to 0-29 but for one pixel in 30, so the classes are
# faint: the port, and the reference with it (tests/test_torch_io_hapi.py
# holds Model.fit to the reference's losses), reaches 0.72 after 2 epochs
# and plateaus near 0.73 on the CPU (chance 0.1)
HAPI_MIN_ACC = 0.6


# the limits' names of the flash kernels' dtypes
_TNAME = {"torch.bfloat16": "bf16", "torch.float16": "f16",
          "torch.float32": "f32"}


# the bool template parameters of the kernels that have them, in order,
# as _kernel_label names them
KERNEL_FLAGS = {"split_decode_kernel": ("paged",),
                "fused_residual_ln_warp_kernel": ("dropout",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def _kernel_label(line: str) -> str:
    """``kernel<dtype, ints...>`` from ptxas' "Compiling entry function
    '<mangled name>'" line (enough to tell the template instances
    apart)."""
    import re
    mangled = line.split("'")[1] if "'" in line else line
    name = re.search(r"\d+([a-z_]+_kernel)I", mangled)
    args = re.findall(r"L([ib])(\d+)E", mangled)
    # a kernel fed by TMA takes tensor maps; the flash kernels name their
    # 16-bit type (bf16 or f16) and quant_matmul's map holds bf16 (its
    # codes are converted to bf16 in shared memory)
    dtype = ("f16" if "6__half" in mangled
             else "bf16" if "bfloat16" in mangled or "CUtensorMap" in mangled
             else "int8" if re.search(r"_kernelIa", mangled) else "f32")
    ints = [v for k, v in args if k == "i"]
    flags = [v == "1" for k, v in args if k == "b"]
    kernel = name.group(1) if name else mangled[:40]
    extra = "".join(f", {v}" for v in ints) + "".join(
        f", {word}" for word, on in zip(KERNEL_FLAGS.get(kernel, ()), flags)
        if on)
    return f"{kernel}<{dtype}{extra}>"


def _named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a nested dict, in sorted-key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


def _to_cpu(tree):
    """A nested dict of tensors copied to the CPU."""
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def _device_rows(torch, prof, n):
    """Kernel rows of a torch.profiler run (an operator row repeats its
    kernels' time): the summed device ms and the ``n`` largest rows as
    (name, ms, calls)."""
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda and dev_us(e) > 0]
    top = sorted(rows, key=dev_us, reverse=True)[:n]
    return (sum(dev_us(e) for e in rows) / 1e3,
            [(e.key, dev_us(e) / 1e3, e.count) for e in top])


def _triton_functors() -> dict:
    """The functors this script hands the primitive factories, as
    ``@triton.jit`` functions (Triton is imported here, on the card's
    machine only; ``tl`` is a module global so Triton resolves it)."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def relu(x):
        return tl.maximum(x, 0.0)

    @triton.jit
    def mul_add_one(a, b):
        return a * b + 1.0

    @triton.jit
    def square(x):
        return x * x

    @triton.jit
    def tile_sum(x):
        return tl.sum(x, axis=0)

    @triton.jit
    def tile_max(x):
        return tl.max(x, axis=0)

    return dict(relu=relu, mul_add_one=mul_add_one, square=square,
                tile_sum=tile_sum, tile_max=tile_max)


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

    def device_ms(self, fn, iters=20) -> float:
        """Device time of one call of ``fn``: the kernels' summed time over
        ``iters`` calls under torch.profiler, without the host's time. A
        session that recorded no kernel (the profiler now and then loses
        one) is taken again, up to three times."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            ms = _device_rows(torch, prof, 0)[0]
            if ms > 0:
                break
        return ms / iters

    # ------------------------------------------------------------ build
    def phase_build(self):
        from paddle_tpu_torch.ops.kernels import _build
        t0 = time.perf_counter()
        secs = _build.build()
        log(f"[build] compiled {sorted(secs)} in "
            f"{time.perf_counter() - t0:.2f} s wall "
            + json.dumps({k: round(v, 2) for k, v in secs.items()}))
        for name in _build.sources():
            kernel, spill = "?", ""
            for line in _build.build_log(name).splitlines():
                if "Compiling entry function" in line:
                    kernel = _kernel_label(line)
                elif "spill" in line:
                    spill = line.strip()
                elif "registers" in line:
                    used = line.split(":", 1)[-1].strip()
                    log(f"[build] {name}: {kernel}: {used}; {spill}")
                elif "error" in line:
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
        tname = _TNAME.get(str(dtype), "f32")
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
                    route=fa.ROUTES[dtype], max_abs_err=err,
                    tol=TOL[tname])
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
        # the kernel alone, without the wrapper's host time (which the
        # CUDA-event time holds at small shapes)
        case["device_ms"] = self.device_ms(
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
        case["tflops"] = ops / (case["ms"] * 1e-3) / 1e12
        case["bound_share"] = case["bound_ms"] / case["ms"]
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
        # the plain loop's blocks must divide S (S = 200: blocks of 8)
        block = math.gcd(S, 128)
        ref = da.bounded_decode_attention(q, kc, vc, pos.long(), scale,
                                          block)
        err = (out - ref).abs().max().item()
        repeat = bool(torch.equal(da.decode_attention(q, kc, vc, pos, scale),
                                  out))
        # garbage past the live length must change nothing
        kg, vg = kc.clone(), vc.clone()
        idx = torch.arange(S, device=self.dev)
        dead = idx[None, :] > (pos[:, None] + Q - 1)
        kg[dead[:, None, :, None].expand_as(kg)] = 1e4
        vg[dead[:, None, :, None].expand_as(vg)] = -1e4
        out_g = da.decode_attention(q, kg, vg, pos, scale)
        torch.cuda.synchronize()
        err_g = (out_g - out).abs().max().item()
        nsplit, chunk = da.decode_split(B, H, S, Q)
        case = dict(kernel="decode_attention", shape=[B, H, S, d], Q=Q,
                    dtype=tname, pos=[int(p) for p in pos], nsplit=nsplit,
                    chunk=chunk, max_abs_err=err, garbage_delta=err_g,
                    tol=DECODE_TOL[tname], repeats_bitwise=repeat)
        log(f"[kernels] {json.dumps(case)}")
        if not bool(torch.isfinite(out).all()) or err > DECODE_TOL[tname] \
                or err_g != 0.0 or not repeat:
            raise AssertionError(f"decode_attention disagrees with its "
                                 f"plain version or with itself: {case}")
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
        case["device_ms"] = self.device_ms(
            lambda: da.decode_attention(q, kc, vc, pos, scale))
        posl = pos.long()
        case["plain_ms"] = self.time_ms(
            lambda: da.bounded_decode_attention(q, kc, vc, posl, scale,
                                               block),
            iters=20)
        qpos = pos.long()[:, None] + torch.arange(Q, device=self.dev)[None]
        mask = (idx[None, None, :] <= qpos[:, :, None])[:, None]  # B,1,Q,S
        sdpa = lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, scale=scale)
        case["library_ms"] = self.time_ms(sdpa, iters=200)
        case["library_device_ms"] = self.device_ms(sdpa)
        case["bound_ms"] = max(t_ops, t_bytes)
        case["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[kernels] {json.dumps(case)}")
        if main:
            self.rows["decode_attention"] = case
        return case

    @staticmethod
    def _causal_pairs(Sq, Skv, causal):
        """(query, key) pairs the mask leaves live."""
        if not causal:
            return Sq * Skv
        off = Skv - Sq
        return sum(min(Skv, i + off + 1) for i in range(Sq))

    def _bound(self, ops, nbytes, tname):
        t_ops = ops / PEAK_OPS[tname] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")

    def _flash_bwd_case(self, B, H, Sq, Skv, d, dtype, causal, time_it,
                        main=False):
        """Both backward kernels against their plain versions (error
        relative to max|grad|), and with time_it their times: each kernel
        alone, the whole backward (di + both kernels) against its 10*d
        bound, the plain versions and SDPA's backward."""
        torch = self.torch
        import torch.nn.functional as F
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        g = torch.Generator(device=self.dev).manual_seed(B * 77 + Sq + Skv)
        mk = lambda s: torch.randn((B, H, s, d), generator=g,
                                   device=self.dev).to(dtype)
        q, k, v, do = mk(Sq), mk(Skv), mk(Skv), mk(Sq)
        scale = 1.0 / d ** 0.5
        tname = _TNAME.get(str(dtype), "f32")
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, scale, causal, True)
        di = fa.softmax_grad_rowsum(out, do)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, scale, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale,
                                            causal)
        torch.cuda.synchronize()
        rq = fa.bwd_dq_ref(q, k, v, do, lse, di, scale, causal)
        rk, rv = fa.bwd_dkv_ref(q, k, v, do, lse, di, scale, causal)
        errs, rel = {}, {}
        for name, a, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            if not bool(torch.isfinite(a.float()).all()):
                raise AssertionError(f"flash backward {name} not finite")
            errs[name] = (a.float() - r.float()).abs().max().item()
            rel[name] = errs[name] / max(r.float().abs().max().item(), 1e-30)
        base = dict(shape=[B, H, Sq, Skv, d], dtype=tname, causal=causal,
                    route=fa.ROUTES[dtype],
                    tol_rel_to_max_grad=BWD_TOL[tname])
        cases = {
            "flash_attention_bwd_dq": dict(
                base, kernel="flash_attention_bwd_dq",
                max_abs_err=errs["dq"], rel_err=rel["dq"]),
            "flash_attention_bwd_dkv": dict(
                base, kernel="flash_attention_bwd_dkv",
                max_abs_err=max(errs["dk"], errs["dv"]),
                rel_err=max(rel["dk"], rel["dv"]))}
        for case in cases.values():
            log(f"[kernels] {json.dumps(case)}")
        if max(rel.values()) > BWD_TOL[tname]:
            raise AssertionError(f"flash backward disagrees with its plain "
                                 f"version: {rel} > {BWD_TOL[tname]}")
        if not time_it:
            return cases
        pairs = self._causal_pairs(Sq, Skv, causal)
        elem = q.element_size()
        row = B * H * Sq * 4                        # one f32 per query row
        qo, kv = q.numel() * elem, k.numel() * elem
        # SDPA's backward computes dq, dk and dv together: the yardstick of
        # both kernels (its forward is outside the timed region)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        if causal and Sq == Skv:
            lout = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                  scale=scale)
        else:
            rows = torch.arange(Sq, device=self.dev)[:, None] + (Skv - Sq)
            mask = (rows >= torch.arange(Skv, device=self.dev)[None, :]) \
                if causal else None
            lout = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                  scale=scale)
        library_ms = self.time_ms(
            lambda: torch.autograd.grad(lout, (ql, kl, vl), do,
                                        retain_graph=True), iters=10)
        if main:
            # information: the library's own bf16 error against the same
            # plain versions, beside the kernels' rel_err above
            lib = torch.autograd.grad(lout, (ql, kl, vl), do,
                                      retain_graph=True)
            log("[kernels] " + json.dumps(dict(
                base, kernel="sdpa backward (information)",
                rel_err={n: ((a.float() - r.float()).abs().max()
                             / r.float().abs().max()).item()
                         for n, a, r in zip(("dq", "dk", "dv"), lib,
                                            (rq, rk, rv))})))
        timed = (
            ("flash_attention_bwd_dq", 6,
             3 * qo + 2 * kv + 2 * row,             # q, dO, dq, k, v, lse, di
             lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, di, scale,
                                               causal),
             lambda: fa.bwd_dq_ref(q, k, v, do, lse, di, scale, causal)),
            ("flash_attention_bwd_dkv", 8,
             2 * qo + 4 * kv + 2 * row,     # q, dO, k, v, dk, dv, lse, di
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale,
                                                causal),
             lambda: fa.bwd_dkv_ref(q, k, v, do, lse, di, scale, causal)))
        for name, ops_per_d, nbytes, kern, plain in timed:
            case = cases[name]
            case["ms"] = self.time_ms(kern, iters=10, warmup=2)
            case["plain_ms"] = self.time_ms(plain, iters=3, warmup=1)
            case["library_ms"] = library_ms
            case["library"] = "sdpa backward (dq, dk, dv together)"
            ops = ops_per_d * d * B * H * pairs
            case.update(self._bound(ops, nbytes, tname))
            case["ops_per_pair"] = f"{ops_per_d}*d"
            case["tflops"] = ops / (case["ms"] * 1e-3) / 1e12
            case["bound_share"] = case["bound_ms"] / case["ms"]
            log(f"[kernels] {json.dumps(case)}")
            if main:
                self.rows[name] = case
        # the whole backward against the least work any backward needs:
        # s, dp, dq, dk, dv once each (10*d per pair) and each tensor moved
        # once; the two-kernel design recomputes s and dp (14*d)
        whole = dict(base, kernel="flash_attention_bwd (di + dq + dk/dv)",
                     ops_per_pair_bound="10*d", ops_per_pair_kernels="14*d")
        whole["ms"] = self.time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, scale,
                                           causal), iters=10, warmup=2)
        whole["plain_ms"] = self.time_ms(
            lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, do, scale,
                                               causal), iters=3, warmup=1)
        whole["library_ms"] = library_ms
        whole.update(self._bound(10 * d * B * H * pairs,
                                 4 * qo + 4 * kv + row, tname))
        whole["bound_ms_kernels_ops"] = \
            14 * d * B * H * pairs / PEAK_OPS[tname] * 1e3
        whole["tflops_14d"] = 14 * d * B * H * pairs / (whole["ms"] * 1e-3) \
            / 1e12
        whole["bound_share"] = whole["bound_ms"] / whole["ms"]
        log(f"[kernels] {json.dumps(whole)}")
        return cases

    def _adamw_check(self, params, grads, m, v, step, lr, wd, label,
                     grad_scale=None):
        """One fused update on the card against the plain version on the
        same leaves (taken first: the kernel updates in place). Returns
        the case dict with the largest absolute error."""
        torch = self.torch
        from paddle_tpu_torch.ops.kernels import fused_adamw as fw
        sc = fw.adamw_scalars(step, lr, 0.9, 0.999, 1e-8, grad_scale,
                              self.dev)
        leaves = [fw.tree_flatten(t) for t in (params, grads, m, v)]
        want = [fw.reference_update(p.reshape(-1), g_.reshape(-1),
                                    mm.reshape(-1), vv.reshape(-1), sc, wd)
                for p, g_, mm, vv in zip(*leaves)]
        got = fw.fused_adamw_update(params, grads, m, v, step, lr, wd=wd,
                                    grad_scale=grad_scale, device=self.dev)
        torch.cuda.synchronize()
        err, worst_p, worst_mv = 0.0, 0.0, 0.0
        for (p, mm, vv), (p2, m2, v2) in zip(
                zip(*(fw.tree_flatten(t) for t in got)), want):
            dp = (p.reshape(-1).float() - p2.float()).abs()
            err = max(err, dp.max().item())
            if p.dtype == torch.bfloat16:
                ref = p2.float().abs()
                floor = ADAMW_CANCEL_FLOOR * ref.max().clamp_min(1e-30)
                worst_p = max(worst_p, (dp / (ref + floor)).max().item())
            for a, b in ((mm, m2), (vv, v2)):
                d_ = (a.reshape(-1) - b).abs().max().item()
                err = max(err, d_)
                worst_mv = max(worst_mv, d_ / max(b.abs().max().item(),
                                                  1e-30))
            if not bool(torch.isfinite(p).all()):
                raise AssertionError("fused_adamw produced non-finite params")
        case = dict(kernel="fused_adamw", case=label,
                    elements=sum(p.numel() for p in leaves[0]),
                    leaves=len(leaves[0]), max_abs_err=err,
                    p_bf16_rel_err=worst_p, moment_rel_err=worst_mv,
                    tol=dict(p_bf16_rel=ADAMW_BF16_REL,
                             p_floor_of_max=ADAMW_CANCEL_FLOOR,
                             moment_rel=ADAMW_MOMENT_TOL))
        log(f"[kernels] {json.dumps(case)}")
        if worst_p > ADAMW_BF16_REL or worst_mv > ADAMW_MOMENT_TOL:
            raise AssertionError(f"fused_adamw disagrees with its plain "
                                 f"version: {case}")
        return case

    def _adamw_cases(self):
        torch = self.torch
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.ops.kernels import fused_adamw as fw
        g = torch.Generator(device=self.dev).manual_seed(7)
        rnd = lambda shape, s, dt: (torch.randn(shape, generator=g,
                                                device=self.dev) * s).to(dt)
        step = torch.tensor(3, dtype=torch.int32, device=self.dev)
        # a ragged f32 leaf (tail past the last 8-element vector), and a bf16
        # leaf at an odd element offset (no 16-byte alignment: scalar loop)
        n = 2 ** 24 + 3
        self._adamw_check({"w": rnd((n,), 1.0, torch.float32)},
                          {"w": rnd((n,), 1.0, torch.float32)},
                          {"w": rnd((n,), 0.1, torch.float32)},
                          {"w": rnd((n,), 0.1, torch.float32).abs()}, step,
                          1e-3, 0.1, "f32 leaf of 2^24+3", grad_scale=0.5)
        odd = [rnd((4097,), s, dt)[1:] for s, dt in (
            (1.0, torch.bfloat16), (1.0, torch.bfloat16),
            (0.1, torch.float32), (0.1, torch.float32))]
        odd[3] = odd[3].abs()
        self._adamw_check(*({"w": t} for t in odd), step, 1e-3, 0.1,
                          "bf16 leaf at an odd offset")
        # every leaf of gpt3_1p3b, bf16 params and grads, f32 moments
        cfg = gpt.gpt3_1p3b()
        shapes = fw.tree_flatten(gpt._shapes(cfg))
        like = gpt._shapes(cfg)
        mk = lambda s, dt: fw.tree_unflatten(
            like, [rnd(shape, s, dt) for shape in shapes])
        params, grads = mk(0.02, torch.bfloat16), mk(1e-3, torch.bfloat16)
        m = mk(1e-4, torch.float32)
        v = fw.tree_unflatten(like, [rnd(shape, 1e-4, torch.float32) ** 2
                                     for shape in shapes])
        case = self._adamw_check(params, grads, m, v, step, 3e-4, 0.1,
                                 "gpt3_1p3b tree, bf16 p, f32 m/v")
        n_el = case["elements"]
        case["ms"] = self.time_ms(
            lambda: fw.fused_adamw_update(params, grads, m, v, step, 3e-4,
                                          wd=0.1, device=self.dev),
            iters=10, warmup=2)
        sc = fw.adamw_scalars(step, 3e-4, 0.9, 0.999, 1e-8, None, self.dev)
        flat = [fw.tree_flatten(t) for t in (params, grads, m, v)]
        case["plain_ms"] = self.time_ms(
            lambda: [fw.reference_update(*leaf, sc, 0.1)
                     for leaf in zip(*flat)], iters=3, warmup=1)
        # 2 + 2 + 4 + 4 bytes read and 2 + 4 + 4 written per element
        case.update(self._bound(12 * n_el, 22 * n_el, "f32"))
        del params, grads, m, v, flat
        torch.cuda.empty_cache()
        # torch's fused AdamW computes the same function only with f32
        # params (bf16 params would get bf16 moments): an f32 tree of the
        # same element count, 16 + 12 bytes an element
        lib_p = [torch.zeros(sh, device=self.dev).requires_grad_()
                 for sh in shapes]
        for t in lib_p:
            t.grad = torch.full_like(t, 1e-3)
        opt = torch.optim.AdamW(lib_p, lr=3e-4, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.1, fused=True)
        case["library_ms"] = self.time_ms(opt.step, iters=10, warmup=2)
        case["library"] = "torch.optim.AdamW(fused=True), f32 params"
        del opt, lib_p
        torch.cuda.empty_cache()
        log(f"[kernels] {json.dumps(case)}")
        self.rows["fused_adamw"] = case

    def device_ms_cold(self, calls, iters=None) -> float:
        """Device time of one call with its operands cold in L2: ``calls``
        each run on their own copy of the operands, in turn, so between two
        calls on one copy all the others (>= 100 MB, twice the 50 MB L2)
        pass through the cache, as the decode tick's 48 weight matrices
        do."""
        turn = iter(range(1 << 62))
        return self.device_ms(lambda: calls[next(turn) % len(calls)](),
                              iters=iters or 2 * len(calls))

    def _qmm_case(self, M, K, N, bits, dtype, time_it, main=False):
        """quant_matmul against its plain version (error relative to
        max|out|) and against itself (two launches, bitwise), and with
        time_it its time beside the bound, the plain version and torch.mm on
        the pre-dequantized weight; the decode form (M <= 8) is also timed
        with its operands cold in L2, beside torch.mm under the same
        rotation."""
        torch = self.torch
        from paddle_tpu_torch.ops.kernels import quant_matmul as qm
        from paddle_tpu_torch.quantization import gpt_quant as gq
        g = torch.Generator(device=self.dev).manual_seed(M * 31 + K + N + bits)
        x = torch.randn((M, K), generator=g, device=self.dev).to(dtype)
        w = torch.randn((K, N), generator=g, device=self.dev) * 0.02
        codes, step = gq.quantize_weight(w, bits, axis=-1)
        wq = gq.pack_int4(codes, axis=0) if bits == 4 else codes
        del w
        tname = "bf16" if dtype == torch.bfloat16 else "f32"
        out = qm.quant_matmul(x, wq, step, bits)
        torch.cuda.synchronize()
        ref = qm.quant_matmul_ref(x, wq, step, bits)
        err = (out - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        route = qm.quant_matmul_route(
            M, K, N, bits, dtype,
            x.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0)
        repeat = bool(torch.equal(qm.quant_matmul(x, wq, step, bits), out))
        case = dict(kernel="quant_matmul", M=M, K=K, N=N, bits=bits,
                    x_dtype=tname, route=route, max_abs_err=err,
                    rel_err=rel, tol_rel_to_max_out=QMM_TOL,
                    repeats_bitwise=repeat)
        if route == "gemv":
            case["split"] = qm.gemv_split(M, K, N, bits,
                                          qm._sm_count(x.device))
        log(f"[kernels] {json.dumps(case)}")
        if not bool(torch.isfinite(out).all()) or rel > QMM_TOL \
                or not repeat:
            raise AssertionError(f"quant_matmul disagrees with its plain "
                                 f"version or with itself: {case}")
        if not time_it:
            return case
        code_bytes = wq.numel()
        nbytes = x.numel() * x.element_size() + code_bytes + 4 * N \
            + 4 * M * N
        case.update(self._bound(2 * M * K * N, nbytes, tname))
        case["ms"] = self.time_ms(lambda: qm.quant_matmul(x, wq, step, bits),
                                  iters=50)
        case["device_ms"] = self.device_ms(
            lambda: qm.quant_matmul(x, wq, step, bits))
        case["plain_ms"] = self.time_ms(
            lambda: qm.quant_matmul_ref(x, wq, step, bits), iters=10)
        w_deq = ((gq.unpack_int4(wq, axis=0) if bits == 4 else wq).float()
                 * step).to(dtype)
        lib = ((lambda: torch.mm(x, w_deq, out_dtype=torch.float32))
               if dtype == torch.bfloat16 else (lambda: x @ w_deq))
        case["library_ms"] = self.time_ms(lib, iters=50)
        case["library"] = ("torch.mm(x, pre-dequantized W, out_dtype=f32) — "
                           "the same product from a full-width weight; no "
                           "PyTorch call multiplies the int8 codes")
        case["codes_GB_per_s"] = code_bytes / case["ms"] / 1e6
        case["TFLOP_per_s"] = 2 * M * K * N / case["ms"] / 1e9
        if M <= 8:
            # L2-cold: enough copies of the codes (and of the bf16 weight)
            # that the rotation streams >= 100 MB
            copies = [wq] + [wq.clone() for _ in range(
                -(-100_000_000 // code_bytes))]
            case["device_ms_cold"] = self.device_ms_cold(
                [lambda c=c: qm.quant_matmul(x, c, step, bits)
                 for c in copies])
            del copies
            w_copies = [w_deq] + [w_deq.clone() for _ in range(
                -(-100_000_000 // (w_deq.numel() * w_deq.element_size())))]
            case["library_device_ms_cold"] = self.device_ms_cold(
                [lambda c=c: torch.mm(x, c, out_dtype=torch.float32)
                 if dtype == torch.bfloat16 else x @ c for c in w_copies])
            del w_copies
            case["codes_GB_per_s_cold"] = code_bytes \
                / case["device_ms_cold"] / 1e6
        log(f"[kernels] {json.dumps(case)}")
        if main:
            self.rows["quant_matmul"] = case
        return case

    def _decode_q8_case(self, B, H, S, d, Q, time_it, main=False):
        """decode_attention_q8 against its plain bounded version on a
        (codes, steps) cache, garbage past each row's live length, and
        with time_it its times (SDPA over the pre-dequantized bf16 cache
        as the library yardstick)."""
        torch = self.torch
        import torch.nn.functional as F
        from paddle_tpu_torch.ops.kernels import decode_attention as da
        from paddle_tpu_torch.quantization.gpt_quant import quantize_rows
        g = torch.Generator(device=self.dev).manual_seed(B * 101 + S + Q)
        q = torch.randn((B, H, Q, d), generator=g, device=self.dev).to(
            torch.bfloat16)
        kc = quantize_rows(torch.randn((B, H, S, d), generator=g,
                                       device=self.dev))
        vc = quantize_rows(torch.randn((B, H, S, d), generator=g,
                                       device=self.dev))
        pos = torch.linspace(0, S - Q, B, device=self.dev).round().to(
            torch.int32)
        scale = 1.0 / d ** 0.5
        out = da.decode_attention_q8(q, kc, vc, pos, scale)
        torch.cuda.synchronize()
        # the plain loop's blocks must divide S (S = 200: blocks of 8)
        block = math.gcd(S, 128)
        ref = da.bounded_decode_attention(q, kc, vc, pos.long(), scale,
                                          block)
        err = (out - ref).abs().max().item()
        repeat = bool(torch.equal(
            da.decode_attention_q8(q, kc, vc, pos, scale), out))
        idx = torch.arange(S, device=self.dev)
        dead = idx[None, :] > (pos[:, None] + Q - 1)       # [B, S]
        kg = tuple(t.clone() for t in kc)
        vg = tuple(t.clone() for t in vc)
        for (codes, steps), fill in ((kg, 127), (vg, -127)):
            codes[dead[:, None, :, None].expand_as(codes)] = fill
            steps[dead[:, None, :].expand_as(steps)] = 1e4
        out_g = da.decode_attention_q8(q, kg, vg, pos, scale)
        torch.cuda.synchronize()
        err_g = (out_g - out).abs().max().item()
        del kg, vg
        nsplit, chunk = da.decode_split_q8(B, H, S, Q)
        case = dict(kernel="decode_attention_q8", shape=[B, H, S, d], Q=Q,
                    cache="int8 codes + f32 steps",
                    pos=[int(p) for p in pos], nsplit=nsplit, chunk=chunk,
                    max_abs_err=err,
                    garbage_delta=err_g, tol=DECODE_TOL["f32"],
                    repeats_bitwise=repeat)
        log(f"[kernels] {json.dumps(case)}")
        if not bool(torch.isfinite(out).all()) or err > DECODE_TOL["f32"] \
                or err_g != 0.0 or not repeat:
            raise AssertionError(f"decode_attention_q8 disagrees with its "
                                 f"plain version or with itself: {case}")
        if not time_it:
            return case
        live = sum(min(int(p) + Q, S) for p in pos)
        # codes 1 byte an element, one f32 step per position and head
        nbytes = 2 * H * live * (d + 4) + q.numel() * q.element_size() \
            + out.numel() * 4 + B * 4
        ops = sum(4 * H * d * (int(p) + j + 1) for p in pos for j in range(Q))
        case.update(self._bound(ops, nbytes, "f32"))
        case["ms"] = self.time_ms(
            lambda: da.decode_attention_q8(q, kc, vc, pos, scale), iters=200)
        case["device_ms"] = self.device_ms(
            lambda: da.decode_attention_q8(q, kc, vc, pos, scale))
        posl = pos.long()
        case["plain_ms"] = self.time_ms(
            lambda: da.bounded_decode_attention(q, kc, vc, posl, scale,
                                               block), iters=20)
        kf = (kc[0].float() * kc[1][..., None]).to(torch.bfloat16)
        vf = (vc[0].float() * vc[1][..., None]).to(torch.bfloat16)
        qpos = posl[:, None] + torch.arange(Q, device=self.dev)[None]
        mask = (idx[None, None, :] <= qpos[:, :, None])[:, None]  # B,1,Q,S
        sdpa = lambda: F.scaled_dot_product_attention(
            q, kf, vf, attn_mask=mask, scale=scale)
        case["library_ms"] = self.time_ms(sdpa, iters=200)
        case["library_device_ms"] = self.device_ms(sdpa)
        case["library"] = "sdpa, explicit mask, pre-dequantized bf16 cache"
        log(f"[kernels] {json.dumps(case)}")
        if main:
            self.rows["decode_attention_q8"] = case
        return case

    def _paged_case(self, B, H, ps, nb, d, Q, quant, pos, time_it,
                    main=False, spare=1):
        """decode_attention_paged (bf16 pool) or decode_attention_paged_q8
        (int8 codes + f32 steps) against its plain version, bitwise against
        the dense kernel over the gathered view, unchanged by garbage in
        the scratch page and in unowned pages; with time_it its times
        beside the bound, the plain version and SDPA on the gathered
        bf16 view (alone, and with the gather). ``pos`` [B] positions;
        the table is a shuffle of a pool of 1 + B * nb + spare pages,
        entries past each row's live pages name the scratch page 0."""
        torch = self.torch
        import torch.nn.functional as F
        from paddle_tpu_torch.ops.kernels import decode_attention as da
        from paddle_tpu_torch.quantization.gpt_quant import quantize_rows
        name = "decode_attention_paged_q8" if quant else \
            "decode_attention_paged"
        P = 1 + B * nb + spare
        g = torch.Generator(device=self.dev).manual_seed(
            B * 1009 + ps * nb + Q + quant)
        q = torch.randn((B, H, Q, d), generator=g, device=self.dev).to(
            torch.bfloat16)
        mk = lambda: torch.randn((P, H, ps, d), generator=g, device=self.dev)
        kp, vp = ((quantize_rows(mk()), quantize_rows(mk())) if quant
                  else (mk().to(torch.bfloat16), mk().to(torch.bfloat16)))
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.dev)
        perm = torch.randperm(P - 1, generator=g, device=self.dev) + 1
        ptab = perm[:B * nb].reshape(B, nb).to(torch.int32)
        live_pages = (pos.long() + Q + ps - 1) // ps           # [B]
        dead = torch.arange(nb, device=self.dev)[None, :] \
            >= live_pages[:, None]
        ptab = torch.where(dead, torch.zeros_like(ptab), ptab).contiguous()
        scale = 1.0 / d ** 0.5
        kern = da.decode_attention_paged_q8 if quant \
            else da.decode_attention_paged
        out = kern(q, kp, vp, pos, ptab, scale)
        torch.cuda.synchronize()
        ref = da.bounded_decode_attention(q, kp, vp, pos.long(), scale, ps,
                                          ptab=ptab)
        err = (out - ref).abs().max().item()
        # the dense kernel over the gathered view: the same float ops
        kv, vv = da.paged_view(kp, ptab), da.paged_view(vp, ptab)
        kv, vv = ((tuple(t.contiguous() for t in kv),
                   tuple(t.contiguous() for t in vv)) if quant
                  else (kv.contiguous(), vv.contiguous()))
        dense_kern = da.decode_attention_q8 if quant else da.decode_attention
        dense = dense_kern(q, kv, vv, pos, scale, block=ps)
        # garbage in page 0 and in the pages no row owns changes nothing
        owned = torch.zeros(P, dtype=torch.bool, device=self.dev)
        owned[ptab.long().flatten()] = True
        owned[0] = False
        junk = ~owned
        kg = tuple(t.clone() for t in kp) if quant else kp.clone()
        vg = tuple(t.clone() for t in vp) if quant else vp.clone()
        for leaf, fill in ((kg, 1.0), (vg, -1.0)):
            if quant:
                leaf[0][junk] = int(127 * fill)
                leaf[1][junk] = 1e4
            else:
                leaf[junk] = 1e4 * fill
        out_g = kern(q, kg, vg, pos, ptab, scale)
        torch.cuda.synchronize()
        del kg, vg
        bitwise = bool(torch.equal(out, dense))
        repeat = bool(torch.equal(kern(q, kp, vp, pos, ptab, scale), out))
        err_g = (out_g - out).abs().max().item()
        tol = DECODE_TOL["f32"]
        case = dict(kernel=name, B=B, H=H, page_size=ps, pages_per_row=nb,
                    pool_pages=P, d=d, Q=Q, pos=[int(p) for p in pos],
                    dead_entries=int(dead.sum()), max_abs_err=err, tol=tol,
                    bitwise_equal_dense_kernel_on_view=bitwise,
                    repeats_bitwise=repeat, garbage_delta=err_g)
        split = da.decode_split_q8 if quant else da.decode_split
        case["nsplit"], case["chunk"] = split(B, H, nb * ps, Q)
        log(f"[kernels] {json.dumps(case)}")
        if not bool(torch.isfinite(out).all()) or err > tol or not bitwise \
                or not repeat or err_g != 0.0:
            raise AssertionError(f"{name} disagrees: {case}")
        if not time_it:
            return case
        live = sum(min(int(p) + Q, nb * ps) for p in pos)
        pages = int(live_pages.clamp(max=nb).sum())
        per_pos = d + 4 if quant else 2 * d       # bytes a position and head
        nbytes = 2 * H * live * per_pos + q.numel() * q.element_size() \
            + out.numel() * 4 + B * 4 + 4 * pages
        ops = sum(4 * H * d * (int(p) + j + 1) for p in pos for j in range(Q))
        case.update(self._bound(ops, nbytes, "f32"))
        case["ms"] = self.time_ms(lambda: kern(q, kp, vp, pos, ptab, scale),
                                  iters=200)
        case["device_ms"] = self.device_ms(
            lambda: kern(q, kp, vp, pos, ptab, scale))
        posl = pos.long()
        case["plain_ms"] = self.time_ms(
            lambda: da.bounded_decode_attention(q, kp, vp, posl, scale, ps,
                                               ptab=ptab), iters=20)
        case["dense_kernel_ms"] = self.time_ms(
            lambda: dense_kern(q, kv, vv, pos, scale), iters=200)
        S = nb * ps
        idx = torch.arange(S, device=self.dev)
        qpos = posl[:, None] + torch.arange(Q, device=self.dev)[None]
        mask = (idx[None, None, :] <= qpos[:, :, None])[:, None]  # B,1,Q,S

        def view16(pool):
            g_ = da.paged_view(pool, ptab)
            return ((g_[0].float() * g_[1][..., None]).to(torch.bfloat16)
                    if quant else g_)

        k16, v16 = view16(kp), view16(vp)
        sdpa = lambda: F.scaled_dot_product_attention(
            q, k16, v16, attn_mask=mask, scale=scale)
        case["library_ms"] = self.time_ms(sdpa, iters=200)
        case["library_device_ms"] = self.device_ms(sdpa)
        case["library"] = ("sdpa, explicit mask, on the pre-gathered "
                           + ("dequantized " if quant else "")
                           + "bf16 view")
        case["gather_sdpa_ms"] = self.time_ms(
            lambda: F.scaled_dot_product_attention(
                q, view16(kp), view16(vp), attn_mask=mask, scale=scale),
            iters=50)
        log(f"[kernels] {json.dumps(case)}")
        if main:
            self.rows[name] = case
        return case

    def _paged_cases(self):
        """The paged kernels at the server's shape (main), generate's, a
        long cache (Q = 1 and 4) and edge cases (small heads, a 3-row
        window, 8- and 16-key pages, dead table entries; with several
        ranks, a table entry a key at 8-key pages and d = 16, two a key
        group at 16-key pages and d = 128), and the spec replay's
        windows."""
        for quant in (False, True):
            self._paged_case(8, 16, 128, 4, 128, 1, quant,
                             [round(511 * i / 7) for i in range(8)], True,
                             main=True)
            self._paged_case(4, 16, 128, 3, 128, 1, quant,
                             [380, 381, 382, 383], True)
            for Q in (1, 4):
                self._paged_case(8, 16, 128, 16, 128, Q, quant,
                                 [round((2047 - Q) * i / 7)
                                  for i in range(8)], True)
            for ps in (8, 16):
                self._paged_case(3, 4, ps, 64 // ps, 16, 3, quant,
                                 [60, 9, 33], False, spare=3)
            self._paged_case(3, 4, 8, 32, 16, 3, quant, [250, 9, 100],
                             False, spare=3)
            self._paged_case(2, 16, 16, 16, 128, 1, quant, [255, 70], False)
        # the spec w8kv8 replay's draft and verify: 8 slots of 5 pages (512
        # positions and the window's headroom), the verify at Q = 4 timed
        for Q in (1, 4):
            self._paged_case(8, 16, 128, 5, 128, Q, True,
                             [round((639 - Q) * i / 7) for i in range(8)],
                             Q == 4)

    # ------------------------------------------- fused LN and factories
    def _fused_ln_case(self, N, D, dtype, training, p, time_it, main=False):
        """The fused bias-dropout-residual LayerNorm kernel against its plain
        version on the same inputs (f32 params drawn from a seed)."""
        torch = self.torch
        import torch.nn.functional as F
        from paddle_tpu_torch.ops.kernels import fused_residual_ln as fr
        g = torch.Generator(device=self.dev).manual_seed(N + D)
        x = torch.randn((N, D), generator=g, device=self.dev).to(dtype)
        res = torch.randn((N, D), generator=g, device=self.dev).to(dtype)
        bias, beta = (torch.randn((D,), generator=g, device=self.dev) * 0.1
                      for _ in range(2))
        gamma = 1.0 + 0.1 * torch.randn((D,), generator=g, device=self.dev)
        seed = 0x5EED0000 + N
        args = (x, bias, res, gamma, beta)
        kw = dict(p=p, eps=1e-5, training=training, seed=seed)
        out = fr.fused_bias_dropout_residual_ln(*args, **kw)
        torch.cuda.synchronize()
        ref = fr.fused_bias_dropout_residual_ln_ref(*args, seed, p, 1e-5,
                                                    training)
        tname = {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dtype,
                                                                  "f32")
        # f16 has 3 more mantissa bits than bf16: bf16's step holds it
        tol = FLN_TOL["f32" if tname == "f32" else "bf16"]
        # relative to max(|plain|, 1): a mask bit off is an O(1) error
        err = ((out.float() - ref.float()).abs()
               / ref.float().abs().clamp_min(1.0)).max().item()
        repeat = bool(torch.equal(
            fr.fused_bias_dropout_residual_ln(*args, **kw), out))
        route = fr.fused_residual_ln_route(D, dtype, True)
        case = dict(kernel="fused_residual_ln", shape=[N, D], dtype=tname,
                    route=route, training=training, p=p, max_abs_err=err,
                    tol=tol, repeats_bitwise=repeat)
        log(f"[kernels] {json.dumps(case)}")
        if not bool(torch.isfinite(out.float()).all()) or err > tol \
                or not repeat:
            raise AssertionError(f"fused_residual_ln disagrees with its plain "
                                 f"version or with itself: {case}")
        if not time_it:
            return case
        case["ms"] = self.time_ms(
            lambda: fr.fused_bias_dropout_residual_ln(*args, **kw), iters=100)
        case["device_ms"] = self.device_ms(
            lambda: fr.fused_bias_dropout_residual_ln(*args, **kw))
        case["plain_ms"] = self.time_ms(
            lambda: fr.fused_bias_dropout_residual_ln_ref(
                *args, seed, p, 1e-5, training), iters=10)
        # the library's LayerNorm on the pre-summed input (eval: no mask)
        h = (x.float() + bias + res.float()).to(dtype)
        gl, bl = gamma.to(dtype), beta.to(dtype)
        case["library_ms"] = self.time_ms(
            lambda: F.layer_norm(h, (D,), gl, bl, 1e-5), iters=100)
        case["library"] = "F.layer_norm on x + bias + residual, params in x's dtype"
        elem = x.element_size()
        # x and residual read, y written; the three f32 [D] params read
        nbytes = 3 * N * D * elem + 3 * D * 4
        case.update(self._bound(30 * N * D, nbytes, "f32"))
        log(f"[kernels] {json.dumps(case)}")
        if main:
            self.rows["fused_residual_ln"] = case
        return case

    def _fused_ln_cases(self):
        torch = self.torch
        from paddle_tpu_torch.ops.kernels import fused_residual_ln as fr
        bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
        # the incubate phase's shape: gpt3_1p3b's d_model over the train
        # phase's B x S = 4 x 2048 tokens, training (p = 0.1) and eval
        for dt in (bf16, f32, f16):
            for training in (True, False):
                self._fused_ln_case(4 * 2048, 2048, dt, training, 0.1,
                                    dt is bf16,
                                    main=dt is bf16 and training)
        # the warp route (D = 2048, 96, 64, one row, 70000 rows: the hash's
        # row wraps past 2^16) and the block route (D = 2050: rows not
        # 16-byte aligned; D = 8192: too wide for a warp)
        for N, D in ((1, 2048), (1000, 2048), (1000, 96), (77, 2050),
                     (3, 8192), (70000, 64)):
            for dt in (bf16, f32, f16):
                self._fused_ln_case(N, D, dt, True, 0.5, False)
        for p in (1e-6, 0.9):
            self._fused_ln_case(1000, 2048, bf16, True, p, False)
        wide = torch.zeros((2, fr.MAX_D + 1), device=self.dev)
        vec = torch.zeros(fr.MAX_D + 1, device=self.dev)
        try:
            fr.fused_bias_dropout_residual_ln(wide, vec, wide, vec, vec)
        except ValueError as e:
            log(f"[kernels] fused_residual_ln D={fr.MAX_D + 1} raises: {e}")
        else:
            raise AssertionError("fused_residual_ln took a row past MAX_D")

    def _triton_functors(self):
        if getattr(self, "_functors", None) is None:
            self._functors = _triton_functors()
        return self._functors

    def _factory_cases(self):
        """elementwise_kernel and reduce_kernel (Triton) against their plain
        versions: ReLU and a*b+1, sum and max, at 2^24 f32 (timed), ragged
        sizes and empty input."""
        torch = self.torch
        from paddle_tpu_torch.ops.kernels import primitives as prim
        fn = self._triton_functors()
        g = torch.Generator(device=self.dev).manual_seed(24)
        cases = [("relu", fn["relu"], lambda v: torch.clamp_min(v, 0.0), 1,
                  torch.relu),
                 ("a*b+1", fn["mul_add_one"], lambda a, b: a * b + 1.0, 2,
                  None)]
        for n in (2 ** 24, 100, 407, 0):
            for name, jit_fn, plain, arity, lib in cases:
                ops = [torch.randn((n,), generator=g, device=self.dev)
                       for _ in range(arity)]
                run = prim.elementwise_kernel(jit_fn)
                out = run(*ops)
                torch.cuda.synchronize()
                ref = prim.elementwise_plain(plain, ops, 4096)
                # a*b+1 may fuse into one multiply-add: one f32 rounding
                err = ((out - ref).abs() / ref.abs().clamp_min(1.0)).max(
                    ).item() if n else 0.0
                tol = 0.0 if name == "relu" else 2 ** -22
                case = dict(kernel="elementwise_kernel", functor=name, n=n,
                            max_abs_err=err, tol=tol,
                            shape_ok=out.shape == ops[0].shape)
                if err > tol or not case["shape_ok"]:
                    raise AssertionError(f"elementwise_kernel disagrees with "
                                         f"its plain version: {case}")
                if n == 2 ** 24:
                    case["ms"] = self.time_ms(lambda: run(*ops), iters=100)
                    case["device_ms"] = self.device_ms(lambda: run(*ops))
                    case["plain_ms"] = self.time_ms(
                        lambda: prim.elementwise_plain(plain, ops, 4096),
                        iters=2, warmup=1)
                    case["library_ms"] = self.time_ms(
                        lambda: lib(*ops), iters=100) if lib else None
                    case.update(self._bound(n, 4 * n * (arity + 1), "f32"))
                    if name == "relu":
                        self.rows["elementwise_kernel"] = case
                log(f"[kernels] {json.dumps(case)}")
        for n in (2 ** 24, 1000, 0):
            for name, jit_fn, plain, ident, lib in (
                    ("sum", fn["tile_sum"], torch.sum, 0.0, torch.sum),
                    ("max", fn["tile_max"], torch.amax, -float("inf"),
                     torch.amax)):
                # sums of uniform [0, 1) values (no cancellation), so the
                # summation order shows as a relative error; max of normals
                x = (torch.rand if name == "sum" else torch.randn)(
                    (n,), generator=g, device=self.dev)
                run = prim.reduce_kernel(jit_fn, ident)
                out = run(x)
                torch.cuda.synchronize()
                ref = prim.reduce_plain(plain, ident, x, 4096)
                if name == "sum":    # 1e-6 relative: the order differs
                    # (0.5 of a sum near 8.4e6 measured at 2**24, one f32
                    # ulp); the float64 sum holds both f32 orders
                    ref64 = x.double().sum().item()
                    err = max(abs(out.item() - ref.item()),
                              abs(out.item() - ref64))
                    tol = 1e-6 * abs(ref64)
                else:                # max is exact
                    err, tol = abs(out.item() - ref.item()) if n else 0.0, 0.0
                case = dict(kernel="reduce_kernel", functor=name, n=n,
                            max_abs_err=err, tol=tol, value=out.item())
                if not err <= tol or out.shape != ():
                    raise AssertionError(f"reduce_kernel disagrees with its "
                                         f"plain version: {case}")
                if n == 2 ** 24:
                    case["ms"] = self.time_ms(lambda: run(x), iters=100)
                    case["device_ms"] = self.device_ms(lambda: run(x))
                    case["plain_ms"] = self.time_ms(
                        lambda: prim.reduce_plain(plain, ident, x, 4096),
                        iters=2, warmup=1)
                    case["library_ms"] = self.time_ms(lambda: lib(x),
                                                      iters=100)
                    case.update(self._bound(n, 4 * n + 4, "f32"))
                    if name == "sum":
                        self.rows["reduce_kernel"] = case
                log(f"[kernels] {json.dumps(case)}")


    def phase_kernels(self):
        torch = self.torch
        bf16, f32 = torch.bfloat16, torch.float32
        # the flash forward: generate()'s prefill shape (timed), ragged and
        # offset-diagonal cases in both routes
        for dt in (bf16, f32):
            self._flash_case(4, 16, 256, 256, 128, dt, True, False, True)
            self._flash_case(2, 16, 200, 200, 128, dt, True, False,
                             dt is bf16)
            for lse in (False, True):
                self._flash_case(2, 16, 128, 384, 128, dt, True, lse,
                                 dt is bf16 and not lse)
        self._flash_case(1, 2, 70, 70, 16, f32, False, True, False)
        self._flash_case(1, 2, 33, 97, 64, bf16, True, True, False)
        # the wgmma route at every head dim, its offset diagonal at the
        # model's d, and a ragged tile with the LSE
        for d, causal in ((16, False), (16, True), (32, True), (64, False)):
            self._flash_case(2, 4, 130, 200, d, bf16, causal, True, False)
        self._flash_case(2, 16, 192, 320, 128, bf16, True, False, False)
        self._flash_case(2, 16, 200, 200, 128, bf16, True, True, False)
        for dt in (bf16, f32):
            for Q in (1, 4):
                self._decode_case(8, 16, 2048, 128, Q, dt, dt is bf16)
        # the server phase's decode shape: 8 slots, 512-position cache
        self._decode_case(8, 16, 512, 128, 1, bf16, True, main=True)
        # generate()'s decode shape (B=4, cache padded to 384: 6 ranks), and
        # edges: small heads, a 3-row window (one rank, and 4 at S = 256),
        # and 3 ranks whose last chunk holds 8 keys (S = 200) at d = 32 and
        # 64 in both dtypes
        self._decode_case(4, 16, 384, 128, 1, bf16, True)
        self._decode_case(3, 4, 64, 16, 3, f32, False)
        self._decode_case(3, 4, 256, 16, 3, f32, False)
        for dt in (bf16, f32):
            self._decode_case(2, 4, 200, 64, 2, dt, False)
            self._decode_case(2, 4, 200, 32, 1, dt, False)
        # the spec phase's windows: its generate-shaped session (B=4, cache
        # padded to 512 with the window's headroom; the verify at Q = 4
        # timed) and the replay's separate draft and verify (8 slots, 640)
        for Q in (1, 4):
            self._decode_case(4, 16, 512, 128, Q, bf16, Q == 4)
            self._decode_case(8, 16, 640, 128, Q, bf16, False)
        # the train phase's attention shape, forward (the timed main row)
        # and backward
        self._flash_case(4, 16, 2048, 2048, 128, bf16, True, True, True,
                         main=True)
        self._flash_bwd_case(4, 16, 2048, 2048, 128, bf16, True, True,
                             main=True)
        self._flash_bwd_case(2, 16, 200, 200, 128, bf16, True, False)
        self._flash_bwd_case(2, 4, 256, 256, 64, f32, True, False)
        # the eager phase's attention: the f32 CUDA-core routes at B=1 x
        # S=2048, d=128 (timed, beside the bf16 rows)
        self._flash_case(1, 16, 2048, 2048, 128, f32, True, True, True)
        self._flash_bwd_case(1, 16, 2048, 2048, 128, f32, True, True)
        self._flash_bwd_case(1, 2, 70, 70, 16, f32, False, False)
        self._flash_bwd_case(1, 2, 33, 97, 32, bf16, True, False)
        # the wgmma route's offset diagonal (Sq < Skv) at the model's d
        self._flash_bwd_case(2, 16, 192, 320, 128, bf16, True, False)
        self._adamw_cases()
        # quant_matmul at the quant phase's FFN shapes: decode (the gemv
        # route at M = 1, 2, 4, 8; generate()'s B = 4 and the engine's 8
        # slots timed, warm and L2-cold) and a B=4 x P=256 prefill
        # (M = 1024), w_in and w_out
        for bits in (8, 4):
            for K, N in ((2048, 8192), (8192, 2048)):
                for M in (1, 2, 4, 8, 1024):
                    self._qmm_case(M, K, N, bits, bf16, M in (4, 8, 1024),
                                   main=(bits, K, M) == (8, 2048, 8))
            # ragged M on the wgmma route (one partial 128-row block)
            for M in (37, 100):
                self._qmm_case(M, 2048, 8192, bits, bf16, False)
        # the spec w8kv8 replay's verify (8 slots x a 4-token window, timed)
        # and its 128-token prefill chunks, both on the wgmma route
        for K, N in ((2048, 8192), (8192, 2048)):
            for M in (32, 128):
                self._qmm_case(M, K, N, 8, bf16, M == 32)
        for bits in (8, 4):
            # ragged edges: the skinny kernel over several row blocks (f32
            # x, and bf16 x at N % 16 != 0, which gemv cannot map), the
            # wmma route (N % 16 != 0: no tensor map) and its tile's masks,
            # and gemv with a ragged K and a part column tile
            for M, dt in ((3, f32), (20, f32), (37, bf16), (3, bf16)):
                self._qmm_case(M, 48, 200, bits, dt, False)
            for M in (1, 3, 8):
                self._qmm_case(M, 48, 208, bits, bf16, False)
            self._qmm_case(5, 1000, 400, bits, bf16, False)
        # decode_attention_q8: the server's decode shape (main), generate's,
        # a long cache, and edge cases (small heads, a 3-row window; S = 200
        # with 3 ranks of 96 keys, two of them dead for the row at pos 0)
        self._decode_q8_case(8, 16, 512, 128, 1, True, main=True)
        self._decode_q8_case(4, 16, 384, 128, 1, True)
        for Q in (1, 4):
            self._decode_q8_case(8, 16, 2048, 128, Q, True)
        self._decode_q8_case(3, 4, 64, 16, 3, False)
        self._decode_q8_case(3, 4, 200, 16, 3, False)
        self._paged_cases()
        self._fused_ln_cases()
        self._factory_cases()

    # ------------------------------------------------------ main path
    def _counters(self):
        """The kernel wrappers by kernel name. Their counters count what
        the device ran: a replayed CUDA graph adds the launches its
        capture recorded (``ops.kernels.launch_counts``)."""
        from paddle_tpu_torch.ops.kernels import launch_counts
        return launch_counts.counters()

    def _zero_counts(self):
        from paddle_tpu_torch.ops.kernels import launch_counts
        launch_counts.zero()

    @staticmethod
    def _by_q() -> dict:
        """Decode-attention launches by window width, every form summed
        (the wrappers' ``by_q``), the widths that ran only."""
        from paddle_tpu_torch.ops.kernels import decode_attention as da
        out = {}
        for fn in (da.decode_attention, da.decode_attention_q8,
                   da.decode_attention_paged, da.decode_attention_paged_q8):
            for q, n in fn.by_q.items():
                if n:
                    out[q] = out.get(q, 0) + n
        return out

    def _read_counts(self, path: str, need) -> dict:
        """Counts of one main-path run; every kernel in ``need`` must have
        launched, and the counts add to the kernels line."""
        counts = {n: fn.launches for n, fn in self._counters().items()}
        log(f"[{path}] kernel launches {json.dumps(counts)}")
        from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
        if quant_matmul.launches:
            log(f"[{path}] quant_matmul routes "
                f"{json.dumps(quant_matmul.routes)}")
        for n in need:
            if counts[n] <= 0:
                raise AssertionError(f"{path}: kernel {n} never launched")
        for n, c in counts.items():
            row = self.rows.setdefault(n, {})
            row["launches"] = row.get("launches", 0) + c
        return counts

    def _weights(self, cfg, reference=False) -> dict:
        """The weights of a CPU/card parity gate, keyed by device, equal
        on both: the numpy N(0, 0.02) draw from seed 0 these gates were
        calibrated on (what ``init_params`` drew before it took the
        reference's keys: one layer at a time, w_o and w_out divided in
        f32 before the cast). ``reference``:
        ``init_params(cfg, seed=0)``, the reference's draw, drawn on the
        card and copied (the sampling phase holds the card's draw bitwise
        to the CPU's)."""
        import numpy as np
        from paddle_tpu_torch.models import gpt
        if reference:
            card = gpt.init_params(cfg, seed=0, device=self.dev)
            return {"cpu": _to_cpu(card), str(self.dev): card}
        rng = np.random.default_rng(0)
        L, shapes = cfg.n_layers, gpt._shapes(cfg)

        def normal(shape, div=None):
            x = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                0.02)
            x = x if div is None else x / np.float32(div)
            return self.torch.from_numpy(x).to(cfg.dtype)

        blocks = {}
        for name, shape in shapes["blocks"].items():
            if name.startswith("ln") and name.endswith("_g"):
                blocks[name] = self.torch.ones(shape, dtype=cfg.dtype)
            elif name.startswith(("b_", "ln")):
                blocks[name] = self.torch.zeros(shape, dtype=cfg.dtype)
            else:
                div = (2 * L) ** 0.5 if name in ("w_o", "w_out") else None
                blocks[name] = self.torch.stack(
                    [normal(shape[1:], div) for _ in range(L)])
        cpu = {"wte": normal(shapes["wte"]), "wpe": normal(shapes["wpe"]),
               "blocks": blocks,
               "lnf_g": self.torch.ones(shapes["lnf_g"], dtype=cfg.dtype),
               "lnf_b": self.torch.zeros(shapes["lnf_b"], dtype=cfg.dtype)}
        card = {k: ({n: t.to(self.dev) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(self.dev))
                for k, v in cpu.items()}
        return {"cpu": cpu, str(self.dev): card}

    def _model(self):
        if getattr(self, "params", None) is None:
            from paddle_tpu_torch.models import gpt
            self.cfg = gpt.gpt3_1p3b()
            t0 = time.perf_counter()
            self.params = gpt.init_params(self.cfg, seed=0, device=self.dev)
            self.torch.cuda.synchronize()
            n = sum(t.numel() for t in self.params["blocks"].values()) \
                + self.params["wte"].numel() + self.params["wpe"].numel()
            log(f"[model] gpt3_1p3b: {n / 1e9:.3f} B params bf16, the "
                f"reference's init_params draw (seed 0) in "
                f"{time.perf_counter() - t0:.1f} s")
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
        self._scan_generate(cfg, params)

    def _scan_generate(self, cfg, params, B=2, P=64, N=16):
        """The scan prefill A/B mode beside full on B x P (+N): prefill ms
        and logits of both (bf16 tolerance TOL), greedy streams of
        generate() in each mode equal (or parted where the full path's
        top-two gap is within the two paths' logits difference, the
        margin rule of _streams_check), and exact launches: scan runs the
        decode kernel once a layer a prompt token and a decode step (the
        last new token takes no forward), full the flash forward once a
        layer."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        L = cfg.n_layers
        prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, P))
        tok = torch.as_tensor(prompt, device=self.dev)
        line, logits = dict(batch=B, prompt=P, new_tokens=N), {}
        for mode, fn in (("full", gpt.prefill), ("scan", gpt.scan_prefill)):
            ms = []
            for _ in range(3):
                kc, vc = gpt.init_kv_cache(cfg, B, gpt.pad_cache_len(
                    P + N, cfg.decode_block), device=self.dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits[mode], _, _ = fn(params, cfg, tok, kc, vc)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            line[f"{mode}_prefill_ms"] = round(min(ms[1:]), 3)
        err = float((logits["full"] - logits["scan"]).abs().max())
        line.update(prefill_logits_max_abs_err=err, tol=TOL["bf16"],
                    scan_over_full=round(line["scan_prefill_ms"]
                                         / line["full_prefill_ms"], 2))
        outs = {}
        for mode, want in (
                ("scan", {"decode_attention": L * (P + N - 1)}),
                ("full", {"flash_attention_fwd": L,
                          "decode_attention": L * (N - 1)})):
            self._zero_counts()
            outs[mode] = gpt.generate(params, cfg, prompt, N,
                                      prefill_mode=mode, device=self.dev)
            torch.cuda.synchronize()
            counts = self._read_counts(f"generate prefill_mode={mode}",
                                       tuple(want))
            self._expect_counts(f"generate prefill_mode={mode}", counts,
                                want)
        line["streams"] = self._streams_check(
            "generate scan", params, cfg, [p for p in prompt],
            [o[P:].tolist() for o in outs["full"].cpu()],
            [o[P:].tolist() for o in outs["scan"].cpu()])
        log("[generate] " + json.dumps(line))
        if not err <= TOL["bf16"] * max(1.0, float(
                logits["full"].abs().max())):
            raise AssertionError(f"scan prefill logits differ by {err}")

    def _profile(self, cfg, params, prompt):
        """Where the time of the main path goes: torch.profiler over one
        B=4 x P=256 prefill and over 16 decode steps, eagerly and as 16
        replays of one captured step, printing the wall time with and
        without the profiler, the summed device time (one stream, so
        device time over unprofiled wall is the busy share) and the
        kernels that take the most device time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch.framework.cuda_graph import TickGraph
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

        # the same 16 steps, each a replay of one captured step on device
        # state (generate()'s form: the token and position stay on the card)
        tok, pos = tokens[:, -1].clone(), torch.full((B,), P, device=self.dev)

        def step():
            logits, _, _ = gpt.decode_one_token(params, cfg, tok, pos, kc, vc)
            tok.copy_(logits.argmax(-1))
            pos.add_(1)
            return pos

        graph = TickGraph(step, self.dev)

        def decode_graphed(steps=16):
            tok.copy_(tokens[:, -1])
            pos.fill_(P)
            for _ in range(steps):
                graph()

        for name, fn in (("prefill", prefill), ("decode_x16", decode),
                         ("decode_x16_graphed", decode_graphed)):
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
            busy_ms, top = _device_rows(torch, prof, 8)
            log("[profile] " + json.dumps(dict(
                region=name, batch=B, prompt=P,
                wall_ms_unprofiled=round(plain_ms, 3),
                wall_ms_profiled=round(wall_ms, 3),
                device_busy_ms=round(busy_ms, 3),
                # against the unprofiled wall: the profiler slows the host
                device_idle_share=round(1 - busy_ms / plain_ms, 4)
                if busy_ms else None,
                top=[dict(name=k[:60], ms=round(ms, 3), calls=c)
                     for k, ms, c in top])))

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
            # one width, no buckets: the chunk tick pads to it
            eng.prewarm()
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
        weights = self._weights(cfg)
        for dev in ("cpu", self.dev):
            params = weights[str(dev)]
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

    # ------------------------------------------------------------ quant
    def _expect_counts(self, path, counts, want):
        """Exact launch counts of a counted window; kernels not named in
        ``want`` must not have run."""
        full = {n: want.get(n, 0) for n in counts}
        if counts != full:
            raise AssertionError(f"{path} launches {counts}, expected {full}")

    def _expect_routes(self, path, want=None, decode=0):
        """quant_matmul's launches by route in a counted window: exactly
        ``want``, or (``decode``) no skinny launch and at least ``decode``
        on gemv (a suffix chunk of 8 tokens or fewer takes gemv too)."""
        from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
        routes = dict(quant_matmul.routes)
        if want is not None:
            full = {r: want.get(r, 0) for r in routes}
            if routes != full:
                raise AssertionError(f"{path} quant_matmul routes {routes}, "
                                     f"expected {full}")
        elif routes["skinny"] or routes["gemv"] < decode:
            raise AssertionError(f"{path} quant_matmul routes {routes}: "
                                 f"{decode} bf16 decode launches should "
                                 f"take gemv, none skinny")

    def _server_trace(self, cfg):
        import numpy as np
        rng = np.random.default_rng(1)
        return [(rng.integers(0, cfg.vocab_size, (int(n),)), int(m))
                for n, m in zip(rng.integers(64, 385, 12),
                                rng.integers(16, 65, 12))]

    def _quant_generate(self, tag, qcfg, qp, prompt, N=32):
        """generate() on the quantized model, counted exactly: one explicit
        prefill, generate(n=1) (a prefill) and generate(N) (a prefill and
        N - 1 decode ticks)."""
        torch = self.torch
        from paddle_tpu_torch.models import gpt
        B, P = prompt.shape
        gpt.generate(qp, qcfg, prompt[:2, :16], 2, device=self.dev)  # warm
        torch.cuda.synchronize()
        self._zero_counts()
        kc, vc = gpt.init_kv_cache(qcfg, B, gpt.pad_cache_len(
            P + N, qcfg.decode_block), device=self.dev)
        logits, _, _ = gpt.prefill(qp, qcfg, torch.as_tensor(
            prompt, device=self.dev), kc, vc)
        if not bool(torch.isfinite(logits).all()) \
                or logits.shape != (B, qcfg.vocab_size):
            raise AssertionError(f"{tag} prefill logits bad")
        t = []
        for n in (1, N):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gpt.generate(qp, qcfg, prompt, n, device=self.dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        if out.shape != (B, P + N) or not bool(
                ((out >= 0) & (out < qcfg.vocab_size)).all()):
            raise AssertionError(f"{tag} generate output bad: {out.shape}")
        L = qcfg.n_layers
        # two products a layer, each expert's own with MoE
        per = 2 * L * max(qcfg.moe_experts, 1)
        prefills, ticks = 3, N - 1
        counts = self._read_counts(f"quant {tag} generate", (
            "quant_matmul", "flash_attention_fwd", "decode_attention_q8"))
        self._expect_counts(f"quant {tag} generate", counts, {
            "quant_matmul": per * (prefills + ticks),
            "flash_attention_fwd": L * prefills,
            "decode_attention_q8": L * ticks})
        self._expect_routes(f"quant {tag} generate", {
            "wgmma": per * prefills, "gemv": per * ticks})
        ms_tok = (t[1] - t[0]) / (N - 1) * 1e3
        log("[quant] " + json.dumps(dict(
            mode=tag, path="generate", batch=B, prompt=P, new_tokens=N,
            prefill_ms=round(t[0] * 1e3, 3),
            decode_ms_per_token=round(ms_tok, 3),
            decode_tokens_per_s=round(B / ms_tok * 1e3, 1),
            total_s=round(t[1], 3))))

    def _quant_server(self, tag, qcfg, qp, chunks):
        """The server phase's 12-request replay on the quantized model;
        each replay counted exactly from the session's own tick counters
        (the engine admits through suffix prefill chunks)."""
        torch = self.torch
        from paddle_tpu_torch.inference import GenerationSession
        from paddle_tpu_torch.serving import RequestState, ServingEngine
        sess = GenerationSession(qp, qcfg, max_slots=8, max_prompt_len=384,
                                 max_len=512, device=self.dev)
        log("[quant] " + json.dumps(dict(mode=tag,
                                         quant_stats=sess.quant_stats)))
        trace = self._server_trace(qcfg)
        L = qcfg.n_layers
        for chunk in chunks:
            eng = ServingEngine(sess, max_queue=64, prefill_chunk=chunk,
                                device=self.dev)
            eng.prewarm()       # the tick graphs, before the warm-up request
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
                        f"{tag} {r.request_id}: {r.state} with "
                        f"{len(r.output)} of {m} tokens")
            met = eng.metrics()
            path = f"quant {tag} server(prefill_chunk={chunk})"
            counts = self._read_counts(path, ("quant_matmul",
                                              "decode_attention_q8"))
            self._expect_counts(path, counts, {
                "quant_matmul": 2 * L * (met["prefill_chunks"]
                                         + met["decode_ticks"]),
                "decode_attention_q8": L * met["decode_ticks"]})
            self._expect_routes(path, decode=2 * L * met["decode_ticks"])
            toks = sum(len(r.output) for r in reqs)
            log("[quant] " + json.dumps(dict(
                mode=tag, path="server", prefill_chunk=chunk,
                requests=len(reqs), ticks=ticks,
                suffix_prefills=met["prefill_chunks"],
                decode_ticks=met["decode_ticks"], new_tokens=toks,
                wall_s=round(wall, 3), tokens_per_s=round(toks / wall, 1),
                ttft_ms_p50=met["ttft_ms_p50"], ttft_ms_p99=met["ttft_ms_p99"],
                decode_ms_per_token_p50=met["decode_ms_per_token_p50"])))
            eng.close()

    def phase_quant(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        cfg, params = self._model()
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (4, 256))
        tokens = torch.as_tensor(prompt, device=self.dev)
        kc, vc = gpt.init_kv_cache(cfg, 4, 256, device=self.dev)
        fp_logits = gpt.prefill(params, cfg, tokens, kc, vc)[0]
        del kc, vc
        for mode, bits, chunks in (("int8", 8, (0, 128)),
                                   ("int4", 4, (0,))):
            tag = f"w{bits}kv8"
            qcfg = gpt.gpt3_1p3b(weight_quant=mode, kv_cache_dtype="int8")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qp = quantize_gpt_params(params, qcfg, bits)
            torch.cuda.synchronize()
            log("[quant] " + json.dumps(dict(
                mode=tag, quantize_s=round(time.perf_counter() - t0, 3),
                w_in=list(qp["blocks"]["w_in"].shape),
                wte=list(qp["wte"].shape))))
            self._quant_generate(tag, qcfg, qp, prompt)
            self._quant_server(tag, qcfg, qp, chunks)
            # information, not a limit: the quantized model against bf16
            kc, vc = gpt.init_kv_cache(qcfg, 4, 256, device=self.dev)
            q_logits = gpt.prefill(qp, qcfg, tokens, kc, vc)[0]
            del kc, vc
            log("[quant] " + json.dumps(dict(
                mode=tag, against="bf16 model, one B=4 x P=256 prefill",
                top1_agreement=float((q_logits.argmax(-1)
                                      == fp_logits.argmax(-1)).float()
                                     .mean()),
                max_abs_logit_diff=(q_logits - fp_logits).abs().max().item(),
                max_abs_logit=fp_logits.abs().max().item())))
            if bits == 8:
                self._profile(qcfg, qp, prompt)
            del qp
            torch.cuda.empty_cache()

    def phase_quant_parity(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        fp_cfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32)
        weights = self._weights(fp_cfg)
        prompt = np.random.default_rng(5).integers(0, fp_cfg.vocab_size,
                                                   (2, 100))
        for mode, bits in (("int8", 8), ("int4", 4)):
            cfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32,
                                weight_quant=mode, kv_cache_dtype="int8")
            self._zero_counts()
            sides = {}
            for dev in ("cpu", self.dev):
                qp = quantize_gpt_params(weights[str(dev)], cfg, bits)
                kc, vc = gpt.init_kv_cache(cfg, 2, 128, device=dev)
                logits, _, _ = gpt.prefill(qp, cfg, torch.as_tensor(
                    prompt, device=dev), kc, vc)
                sides[str(dev)] = dict(qp=qp, kc=kc, vc=vc,
                                       logits=[logits.cpu()])
            cpu, card = sides["cpu"], sides[str(self.dev)]
            differ = [n for (n, a), (_, b) in zip(_named_leaves(cpu["qp"]),
                                                  _named_leaves(card["qp"]))
                      if not torch.equal(a, b.cpu())]
            codes_equal = not differ
            toks = cpu["logits"][0].argmax(-1)
            for step in range(4):
                for side, dev in ((cpu, "cpu"), (card, self.dev)):
                    logits, _, _ = gpt.decode_one_token(
                        side["qp"], cfg, toks.to(dev), 100 + step,
                        side["kc"], side["vc"])
                    side["logits"].append(logits.cpu())
                toks = cpu["logits"][-1].argmax(-1)
            # f32 x: every launch on the card took the skinny kernel
            self._expect_routes(f"quant_parity w{bits}kv8", {
                "skinny": 2 * cfg.n_layers * 5})
            errs = [(c - g).abs().max().item()
                    for c, g in zip(cpu["logits"], card["logits"])]
            same_tokens = all(torch.equal(c.argmax(-1), g.argmax(-1))
                              for c, g in zip(cpu["logits"], card["logits"]))
            log("[quant_parity] " + json.dumps(dict(
                config=f"gpt3_1p3b(n_layers=2, f32, w{bits}kv8)",
                prompt=[2, 100], weight_codes_and_steps_equal=codes_equal,
                leaves_that_differ=differ,
                max_abs_err_prefill=errs[0],
                max_abs_err_decode=max(errs[1:]), tol=QUANT_PARITY_TOL,
                greedy_tokens_identical=same_tokens)))
            if not codes_equal or max(errs) > QUANT_PARITY_TOL \
                    or not same_tokens:
                raise AssertionError(f"w{bits}kv8: CPU and card disagree")
            del sides, cpu, card
        del weights
        torch.cuda.empty_cache()


    # ------------------------------------------------------------ paged
    def _replay(self, tag, sess, trace, chunk, prefix_blocks=0,
                count=True):
        """One seeded trace through a ServingEngine on ``sess``: a warm-up
        request, then the trace with the launch counters zeroed just
        before and read just after. Every request must end DONE with its
        token budget. Returns (streams, the metrics line, counts)."""
        torch = self.torch
        from paddle_tpu_torch.serving import RequestState, ServingEngine
        eng = ServingEngine(sess, max_queue=64, prefill_chunk=chunk,
                            prefix_cache_blocks=prefix_blocks,
                            device=self.dev)
        eng.prewarm()           # the tick graphs, before the warm-up request
        # the warm-up prompt holds no full block: nothing enters the pool
        warm = eng.submit(trace[0][0][:64], max_new_tokens=2)
        eng.run()
        if warm.state is not RequestState.DONE:
            raise AssertionError(f"{tag}: warm-up request did not finish")
        sess.reset_metrics()
        self._zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in trace]
        peak_rows = peak_shared = backpressure = polls = 0
        while eng.pending:
            free, queued = len(sess.free_slots()), eng._queued
            admitted = len(eng.poll()["admitted"])
            polls += 1
            # rows held right after this poll's admissions
            peak_rows = max(peak_rows, sess.max_slots - free + admitted)
            if sess.kv_paged:
                peak_shared = max(peak_shared, sess.kv_page_stats()[2])
            # admission stopped with a slot free and a request queued:
            # the pool had too few pages for the head request
            backpressure += admitted < min(free, queued)
            if polls > 20000:
                raise AssertionError(f"{tag}: replay did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for r, (_, m) in zip(reqs, trace):
            if r.state is not RequestState.DONE or len(r.output) != m:
                raise AssertionError(f"{tag} {r.request_id}: {r.state} with "
                                     f"{len(r.output)} of {m} tokens")
        counts = self._read_counts(tag, ()) if count else None
        met = eng.metrics()
        toks = sum(len(r.output) for r in reqs)
        line = dict(run=tag, prefill_chunk=chunk, requests=len(reqs),
                    polls=polls, suffix_prefills=met["prefill_chunks"],
                    decode_ticks=met["decode_ticks"], new_tokens=toks,
                    wall_s=round(wall, 3), tokens_per_s=round(toks / wall, 1),
                    ttft_ms_p50=met["ttft_ms_p50"],
                    ttft_ms_p99=met["ttft_ms_p99"],
                    decode_ms_per_token_p50=met["decode_ms_per_token_p50"],
                    peak_admitted_rows=peak_rows,
                    page_backpressure_polls=backpressure)
        if sess.kv_paged:
            line.update(kv_pages_total=met["kv_pages_total"],
                        peak_shared_pages=peak_shared)
        if eng.prefix_cache is not None:
            line["prefix_cache"] = met["prefix_cache"]
            line["prefix_hit_tokens"] = sum(r.prefix_hit_tokens
                                            for r in reqs)
        log("[paged] " + json.dumps(line))
        eng.close()
        # the pool's page references go with the engine
        while eng.prefix_cache is not None and len(eng.prefix_cache):
            eng.prefix_cache._evict_one()
        return [list(r.output) for r in reqs], line, counts

    def _expect_tick_counts(self, tag, counts, line, L, kernel,
                            quant=False):
        """Exact counts of a replay: one attention kernel a layer a tick,
        and with quantized weights two quant_matmul a layer a forward."""
        want = {kernel: L * line["decode_ticks"]}
        if quant:
            want["quant_matmul"] = 2 * L * (line["suffix_prefills"]
                                            + line["decode_ticks"])
        self._expect_counts(tag, counts, want)
        if quant:
            self._expect_routes(tag, decode=2 * L * line["decode_ticks"])

    def _shared_prefix_trace(self, cfg, n=12, prefix=256):
        """``n`` requests sharing a ``prefix``-token prefix (two pages),
        each with a unique 16-128-token tail and a 16-64-token budget."""
        import numpy as np
        rng = np.random.default_rng(6)
        shared = rng.integers(0, cfg.vocab_size, (prefix,))
        return [(np.concatenate([shared, rng.integers(
                    0, cfg.vocab_size, (int(t),))]), int(m))
                for t, m in zip(rng.integers(16, 129, n),
                                rng.integers(16, 65, n))]

    def _session(self, params, cfg, paged, kv_pages=None):
        from paddle_tpu_torch.inference import GenerationSession
        return GenerationSession(params, cfg, max_slots=8,
                                 max_prompt_len=384, max_len=512,
                                 kv_paged=paged,
                                 kv_pages=kv_pages if paged else None,
                                 device=self.dev)

    def _tick_profile(self, tag, sess, prompt):
        """16 decode ticks of a session holding 8 admitted rows under
        torch.profiler: wall with and without the profiler, device busy
        time, idle share, top kernels."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        slots = sess.admit(prompt)
        for _ in range(2):
            sess.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            sess.step()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(16):
                sess.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        for s in slots:
            sess.evict(s)
        busy_ms, top = _device_rows(torch, prof, 8)
        log("[profile] " + json.dumps(dict(
            region=f"{tag} session, 16 decode ticks", batch=len(slots),
            prompt=int(prompt.shape[1]),
            wall_ms_unprofiled=round(plain_ms, 3),
            wall_ms_profiled=round(wall_ms, 3),
            device_busy_ms=round(busy_ms, 3),
            device_idle_share=round(1 - busy_ms / plain_ms, 4)
            if busy_ms else None,
            top=[dict(name=k[:60], ms=round(ms, 3), calls=c)
                 for k, ms, c in top])))

    def phase_paged(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        cfg, params = self._model()
        L = cfg.n_layers
        trace = self._server_trace(cfg)
        paged = self._session(params, cfg, True)
        dense = self._session(params, cfg, False)
        if paged.metrics()["kv_pages_total"] != 32:
            raise AssertionError("the paged pool should hold 32 pages")
        # 1. the server trace, paged (33 pages) against dense, both
        # admission modes: equal streams, exact counts
        for chunk in (0, 128):
            out_p, line, counts = self._replay(
                f"paged bf16 chunk={chunk}", paged, trace, chunk)
            self._expect_tick_counts(line["run"], counts, line, L,
                                     "decode_attention_paged")
            out_d, line_d, counts = self._replay(
                f"dense bf16 chunk={chunk}", dense, trace, chunk)
            self._expect_tick_counts(line_d["run"], counts, line_d, L,
                                     "decode_attention")
            same = sum(a == b for a, b in zip(out_p, out_d))
            log(f"[paged] chunk={chunk}: paged and dense streams identical "
                f"for {same}/{len(trace)} requests")
            if same != len(trace):
                raise AssertionError("paged and dense streams differ")
        # 2. half the dense pool's bytes: 16 grantable pages (a dense pool
        # of those bytes holds 4 rows of 512 positions)
        half = self._session(params, cfg, True, kv_pages=17)
        out_h, line, counts = self._replay("paged bf16 kv_pages=17", half,
                                           trace, 128)
        self._expect_tick_counts(line["run"], counts, line, L,
                                 "decode_attention_paged")
        log("[paged] " + json.dumps(dict(
            half_bytes_pool=dict(kv_pages=17, dense_rows_of_same_bytes=4,
                                 peak_admitted_rows=line["peak_admitted_rows"],
                                 page_backpressure_polls=line[
                                     "page_backpressure_polls"],
                                 tokens_per_s=line["tokens_per_s"]))))
        del half
        # 3. a shared-prefix trace, paged and dense, reuse on and off
        shared = self._shared_prefix_trace(cfg)
        streams = {}
        for sess_name, sess in (("paged", paged), ("dense", dense)):
            for blocks in (16, 0):
                tag = f"{sess_name} bf16 shared-prefix reuse={bool(blocks)}"
                out, line, counts = self._replay(tag, sess, shared, 128,
                                                 prefix_blocks=blocks)
                self._expect_tick_counts(
                    tag, counts, line, L, "decode_attention_paged"
                    if sess_name == "paged" else "decode_attention")
                streams[(sess_name, bool(blocks))] = out
        if streams[("paged", True)] != streams[("dense", True)]:
            raise AssertionError("paged and dense streams with prefix reuse "
                                 "differ")
        agree = np.mean([a == b for sa, sb in zip(streams[("paged", True)],
                                                   streams[("paged", False)])
                         for a, b in zip(sa, sb)])
        log("[paged] " + json.dumps(dict(
            shared_prefix="reuse against no reuse (information: the batch "
                          "makeup differs, bf16 rounds differently)",
            top1_agreement=round(float(agree), 4))))
        # 6. where a paged tick's time goes, beside the dense tick
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (8, 256))
        for tag, sess in (("paged", paged), ("dense", dense)):
            self._tick_profile(f"{tag} bf16", sess, prompt)
        del paged, dense
        torch.cuda.empty_cache()
        # 4. the server trace in w8kv8, paged against dense
        qcfg = gpt.gpt3_1p3b(weight_quant="int8", kv_cache_dtype="int8")
        qp = quantize_gpt_params(params, qcfg, 8)
        outs = {}
        for tag, is_paged in (("paged", True), ("dense", False)):
            qsess = self._session(qp, qcfg, is_paged)
            outs[tag], line, counts = self._replay(
                f"{tag} w8kv8 chunk=128", qsess, trace, 128)
            self._expect_tick_counts(
                line["run"], counts, line, L, "decode_attention_paged_q8"
                if is_paged else "decode_attention_q8", quant=True)
            self._tick_profile(f"{tag} w8kv8", qsess, prompt)
            del qsess
        if outs["paged"] != outs["dense"]:
            raise AssertionError("paged and dense w8kv8 streams differ")
        log("[paged] w8kv8: paged and dense streams identical for "
            f"{len(trace)}/{len(trace)} requests")
        del qp
        torch.cuda.empty_cache()

    def phase_paged_parity(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.inference import GenerationSession
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        fp_cfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32)
        prompt = np.random.default_rng(7).integers(0, fp_cfg.vocab_size,
                                                   (2, 100))
        lengths = np.asarray([100, 77])
        # the gate runs on the numpy weights; the reference's draw is
        # compared too, as information (its w8kv8 reading sits at the
        # tolerance: PERF.md, section 7)
        runs = [(tag, tol, gate) for gate in (True, False)
                for tag, tol in (("fp", 1e-4), ("w8kv8", QUANT_PARITY_TOL))]
        for tag, tol, gate in runs:
            if tag == "fp":
                weights = self._weights(fp_cfg, reference=not gate)
            cfg = fp_cfg if tag == "fp" else gpt.gpt3_1p3b(
                n_layers=2, dtype=torch.float32, weight_quant="int8",
                kv_cache_dtype="int8")
            logits = {}
            self._zero_counts()
            for dev in ("cpu", self.dev):
                params = weights[str(dev)] if tag == "fp" else \
                    quantize_gpt_params(weights[str(dev)], cfg, 8)
                sess = GenerationSession(params, cfg, max_slots=2,
                                         max_prompt_len=128, max_len=256,
                                         kv_paged=True, device=dev)
                sess.admit(prompt, lengths)
                # copies: a tick rewrites the session's logits in place
                seen = [sess._logits.to("cpu", copy=True)]
                for _ in range(4):
                    sess.step()
                    seen.append(sess._logits.to("cpu", copy=True))
                logits[str(dev)] = seen
            if tag == "w8kv8":   # f32 x: every launch on the skinny kernel
                from paddle_tpu_torch.ops.kernels.quant_matmul import (
                    quant_matmul)
                if not quant_matmul.launches:
                    raise AssertionError("paged_parity w8kv8: no quant_matmul "
                                         "launch on the card")
                self._expect_routes(f"paged_parity {tag}", {
                    "skinny": quant_matmul.launches})
            cpu, card = logits["cpu"], logits[str(self.dev)]
            errs = [(c - g).abs().max().item() for c, g in zip(cpu, card)]
            same = all(torch.equal(c.argmax(-1), g.argmax(-1))
                       for c, g in zip(cpu, card))
            log("[paged_parity] " + json.dumps(dict(
                config=f"gpt3_1p3b(n_layers=2, f32, {tag}), paged session, "
                       "page size 128", prompt=[2, 100],
                weights="numpy seed 0 (gate)" if gate else
                        "init_params seed 0 (information, not a gate)",
                max_abs_err_prefill=errs[0],
                max_abs_err_decode=max(errs[1:]), tol=tol,
                greedy_tokens_identical=same)))
            if gate and (max(errs) > tol or not same):
                raise AssertionError(f"paged {tag}: CPU and card disagree")
        # on the card: reuse on and off give the same greedy streams
        weights = self._weights(fp_cfg)
        cfg, params = fp_cfg, weights[str(self.dev)]
        trace = [(p, 8) for p, _ in self._shared_prefix_trace(cfg, n=6)]
        streams = []
        for blocks in (16, 0):
            sess = GenerationSession(params, cfg, max_slots=4,
                                     max_prompt_len=384, max_len=512,
                                     kv_paged=True, device=self.dev)
            out, line, _ = self._replay(
                f"paged f32 2-layer shared-prefix reuse={bool(blocks)}",
                sess, trace, 128, prefix_blocks=blocks, count=False)
            streams.append(out)
            if blocks and not line["prefix_hit_tokens"]:
                raise AssertionError("the shared prefix was never reused")
        log(f"[paged_parity] f32 shared-prefix streams with and without "
            f"reuse identical: {streams[0] == streams[1]}")
        if streams[0] != streams[1]:
            raise AssertionError("prefix reuse changed the f32 streams")
        del weights
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ train
    @staticmethod
    def _model_flops(cfg, tokens: int, seq: int) -> float:
        """Model FLOPs of one train step (no recompute counted): 6 per
        token per weight that multiplies activations (every block matrix
        and the tied lm-head; embeddings and LayerNorms are not products)
        plus causal attention, 6 * L * S * D per token (QK^T and PV, half
        the pairs, forward and twice that backward)."""
        D, L, V = cfg.hidden, cfg.n_layers, cfg.vocab_size
        n_mat = L * 12 * D * D + V * D
        return 6.0 * n_mat * tokens + 6.0 * L * seq * D * tokens

    def _step_profile(self, step, params, opt, tokens, labels):
        """One train step under torch.profiler: the device's busy share
        against the unprofiled step time and the kernels that take the most
        device time. Returns the updated (params, opt)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, tokens, labels)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, tokens, labels)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, top = _device_rows(torch, prof, 10)
        # the attention kernels' device time (kernel names from csrc/)
        every = _device_rows(torch, prof, 1 << 30)[1]
        attn = {what: sum(ms for k, ms, _ in every if pat in k)
                for what, pat in (("flash_fwd", "fwd_kernel"),
                                  ("flash_bwd_dq", "bwd_dq_kernel"),
                                  ("flash_bwd_dkv", "bwd_dkv_kernel"))}
        log("[profile] " + json.dumps(dict(
            region="train_step", wall_ms_unprofiled=round(plain_ms, 3),
            wall_ms_profiled=round(wall_ms, 3),
            device_busy_ms=round(busy_ms, 3),
            device_busy_share=round(busy_ms / plain_ms, 4) if busy_ms
            else None,
            attention_device_ms={k: round(v, 3) for k, v in attn.items()},
            attention_device_share={k: round(v / busy_ms, 4) if busy_ms
                                    else None for k, v in attn.items()},
            top=[dict(name=k[:70], ms=round(ms, 3), calls=c,
                      share=round(ms / busy_ms, 4)) for k, ms, c in top])))
        return params, opt

    def phase_train(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        _, params = self._model()
        cfg = gpt.gpt3_1p3b(remat=True, fused_adamw=True, xent_chunks=4)
        B, S, n_timed = 4, 2048, 5
        tok = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                (B, S + 1))
        tokens = torch.as_tensor(tok[:, :-1], device=self.dev)
        labels = torch.as_tensor(tok[:, 1:], device=self.dev)
        opt = gpt.adamw_init(params, dtype=cfg.opt_dtype, device=self.dev)
        step = gpt.build_train_step(cfg, device=self.dev)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, labels)   # warm-up
        losses.append(float(loss))
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        self._zero_counts()
        times = []
        for _ in range(n_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, tokens, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated()
        counts = self._read_counts("train", (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "fused_adamw"))
        # remat runs each block's forward twice (forward, recompute)
        per_step = {"flash_attention_fwd": 2 * cfg.n_layers,
                    "flash_attention_bwd_dq": cfg.n_layers,
                    "flash_attention_bwd_dkv": cfg.n_layers,
                    "fused_adamw": 16}
        self._expect_counts("train", counts,
                            {n: c * n_timed for n, c in per_step.items()})
        step_s = sum(times) / len(times)
        flops = self._model_flops(cfg, B * S, S)
        log("[train] " + json.dumps(dict(
            config="gpt3_1p3b(remat=True, fused_adamw=True, xent_chunks=4)",
            batch=B, seq=S, warmup_step_s=round(warm_s, 3),
            step_ms=[round(t * 1e3, 3) for t in times],
            step_ms_mean=round(step_s * 1e3, 3),
            tokens_per_s=round(B * S / step_s, 1),
            losses=losses, max_memory_allocated_gib=round(peak / 2 ** 30, 3),
            model_flops_per_step=flops,
            mfu_bf16_peak=round(flops / step_s / PEAK_OPS["bf16"], 4),
            mfu_formula="(6*(L*12*D^2 + V*D) + 6*L*S*D) * tokens / step_s "
                        "/ 989e12")))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train losses bad: {losses}")
        params, opt = self._step_profile(step, params, opt, tokens, labels)
        eval_loss = float(gpt.build_eval_step(cfg, device=self.dev)(
            params, tokens, labels))
        out = gpt.generate(params, cfg, tok[:2, :64], 8, device=self.dev)
        ok_out = out.shape == (2, 72) and bool(
            ((out >= 0) & (out < cfg.vocab_size)).all())
        log("[train] " + json.dumps(dict(eval_loss=eval_loss,
                                         generate_shape=list(out.shape))))
        if not np.isfinite(eval_loss) or not ok_out:
            raise AssertionError(f"eval {eval_loss} / generate {out.shape} "
                                 "after training failed")
        del opt
        self.torch.cuda.empty_cache()
        self._remat_policies(tokens, labels)

    def _remat_policies(self, tokens, labels, steps=3):
        """remat_policy "dots" beside "full" on the train phase's batch:
        each from its own copy of the same weights with fresh moments, a
        warm-up step, then ``steps`` timed with the counters zeroed just
        before and read just after (exact launches: the flash forward runs
        twice a layer under both, dots keeps only the weight products).
        Losses and updated params must be bitwise equal (the saved
        products are the values the recompute makes), else within the
        train_parity tolerances with the difference printed. Prints step
        ms, tokens/s, the peak and the peak above what was resident before
        the timed steps."""
        torch = self.torch
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.ops.kernels.fused_adamw import tree_flatten
        _, base = self._model()
        B, S = tokens.shape
        runs = {}
        for policy in ("full", "dots"):
            cfg = gpt.gpt3_1p3b(remat=True, fused_adamw=True, xent_chunks=4,
                                remat_policy=policy)
            params = {k: ({n: t.clone() for n, t in v.items()}
                          if isinstance(v, dict) else v.clone())
                      for k, v in base.items()}
            opt = gpt.adamw_init(params, dtype=cfg.opt_dtype, device=self.dev)
            step = gpt.build_train_step(cfg, device=self.dev)
            params, opt, loss = step(params, opt, tokens, labels)
            losses = [float(loss)]
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            self._zero_counts()
            times = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, loss = step(params, opt, tokens, labels)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(loss))
            peak = torch.cuda.max_memory_allocated()
            counts = self._read_counts(f"train remat_policy={policy}", (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv", "fused_adamw"))
            L = cfg.n_layers
            self._expect_counts(f"train remat_policy={policy}", counts, {
                "flash_attention_fwd": 2 * L * steps,
                "flash_attention_bwd_dq": L * steps,
                "flash_attention_bwd_dkv": L * steps,
                "fused_adamw": 16 * steps})
            step_s = sum(times) / len(times)
            runs[policy] = dict(
                losses=losses, params=[t.cpu() for t in tree_flatten(params)],
                line=dict(remat_policy=policy, batch=B, seq=S,
                          step_ms=[round(t * 1e3, 3) for t in times],
                          step_ms_mean=round(step_s * 1e3, 3),
                          tokens_per_s=round(B * S / step_s, 1),
                          losses=losses,
                          max_memory_allocated_gib=round(peak / 2 ** 30, 3),
                          above_resident_gib=round(
                              (peak - resident) / 2 ** 30, 3)))
            del params, opt, step
            torch.cuda.empty_cache()
        full, dots = runs["full"], runs["dots"]
        bitwise = full["losses"] == dots["losses"] and all(
            torch.equal(a, b) for a, b in zip(full["params"], dots["params"]))
        loss_err = max(abs(a - b) for a, b in zip(full["losses"],
                                                   dots["losses"]))
        param_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(full["params"], dots["params"]))
        for policy in ("full", "dots"):
            log("[train] " + json.dumps(runs[policy]["line"]))
        log("[train] " + json.dumps(dict(
            remat_dots_vs_full=dict(bitwise=bitwise, max_loss_err=loss_err,
                                    max_param_err=param_err),
            dots_minus_full_step_ms=round(
                dots["line"]["step_ms_mean"] - full["line"]["step_ms_mean"],
                3),
            dots_minus_full_peak_gib=round(
                dots["line"]["above_resident_gib"]
                - full["line"]["above_resident_gib"], 3))))
        # train_parity's tolerances: losses 1e-4, params 2 lr a step
        if not bitwise and (loss_err > 1e-4
                            or param_err > 2 * 3e-4 * (steps + 1)):
            raise AssertionError("remat dots and full disagree: losses "
                                 f"{loss_err}, params {param_err}")

    def phase_train_parity(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.ops.kernels.fused_adamw import tree_flatten
        cfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32, fused_adamw=True,
                            remat=True, xent_chunks=2)
        lr, steps = 3e-4, 3
        tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 257))
        sides = {}
        weights = self._weights(cfg)
        for dev in ("cpu", self.dev):
            params = weights.pop(str(dev))
            opt = gpt.adamw_init(params, device=dev)
            step = gpt.build_train_step(cfg, lr=lr, device=dev)
            losses = []
            for _ in range(steps):
                params, opt, loss = step(params, opt, tok[:, :-1],
                                         tok[:, 1:])
                losses.append(float(loss))
            sides[str(dev)] = (losses, [t.cpu() for t in
                                        tree_flatten(params)])
        (lc, pc), (lg, pg) = sides["cpu"], sides[str(self.dev)]
        loss_err = max(abs(a - b) for a, b in zip(lc, lg))
        param_err = max((a - b).abs().max().item() for a, b in zip(pc, pg))
        # AdamW steps every element by about lr whatever its gradient, so
        # an element whose gradient is summation noise may step the other
        # way on the other device: 2 * lr per step
        param_tol = 2 * lr * steps
        log("[train_parity] " + json.dumps(dict(
            config="gpt3_1p3b(n_layers=2, f32, fused_adamw, remat, "
                   "xent_chunks=2)", batch=[2, 256], steps=steps,
            losses_cpu=lc, losses_card=lg, max_loss_err=loss_err,
            loss_tol=1e-4, max_param_err=param_err, param_tol=param_tol)))
        if loss_err > 1e-4 or param_err > param_tol:
            raise AssertionError("CPU and card training disagree")

    # ---------------------------------------------------------- incubate
    def phase_incubate(self):
        """FusedBiasDropoutResidualLayerNorm at d=2048 on [4, 2048, 2048]
        bf16: 3 training forward+backward steps, each followed by a grad-norm
        monitor built from the primitive factories (square, then sum), and
        one eval forward, counted exactly; then the mask and gradient checks
        and a CPU/card comparison."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch
        from paddle_tpu_torch.framework import prng, random
        from paddle_tpu_torch.incubate.nn import (
            FusedBiasDropoutResidualLayerNorm)
        from paddle_tpu_torch.ops.kernels import fused_residual_ln as fr
        from paddle_tpu_torch.ops.kernels import primitives as prim
        B, S, d, p = 4, 2048, 2048, 0.1
        layer = FusedBiasDropoutResidualLayerNorm(d, dropout_rate=p,
                                                  device=self.dev)
        g = torch.Generator(device=self.dev).manual_seed(2048)
        with torch.no_grad():
            for t, base in ((layer.linear_bias, 0.0), (layer.ln_scale, 1.0),
                            (layer.ln_bias, 0.0)):
                t.copy_(base + 0.1 * torch.randn(d, generator=g,
                                                 device=self.dev))
        mk = lambda: torch.randn((B, S, d), generator=g,
                                 device=self.dev).to(torch.bfloat16)
        x, res, gout = mk().requires_grad_(), mk().requires_grad_(), mk()
        fn = self._triton_functors()
        square = prim.elementwise_kernel(fn["square"])
        total = prim.reduce_kernel(fn["tile_sum"], 0.0)
        fused = fr.fused_bias_dropout_residual_ln
        layer.train()
        paddle_tpu_torch.seed(1234)
        torch.cuda.synchronize()
        self._zero_counts()
        outs, grads, norms, times = [], [], [], []
        for step in range(3):
            for t in (x, res, *layer.parameters()):
                t.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = fused.launches
            out = layer(x, res)
            if fused.launches - before != 1:
                raise AssertionError(f"step {step}: {fused.launches - before} "
                                     "fused-LN launches in one forward")
            out.backward(gout)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            params = [t.grad for t in layer.parameters()]
            norms.append(sum(float(total(square(gp))) for gp in params)
                         ** 0.5)
            want = torch.linalg.vector_norm(torch.cat(params)).item()
            if abs(norms[-1] - want) > 1e-5 * want:
                raise AssertionError(f"grad-norm monitor {norms[-1]} against "
                                     f"torch's {want}")
            outs.append(out.detach())
            grads.append([t.grad.clone() for t in (x, res,
                                                   *layer.parameters())])
        layer.eval()
        with torch.no_grad():
            out_eval = layer(x, res)
        counts = self._read_counts("incubate", (
            "fused_residual_ln", "elementwise_kernel", "reduce_kernel"))
        self._expect_counts("incubate", counts, {
            "fused_residual_ln": 4, "elementwise_kernel": 9,
            "reduce_kernel": 9})
        # fresh masks from step to step, the same ones after seed() again
        fresh = all(not torch.equal(outs[i], outs[i + 1]) for i in range(2))
        layer.train()
        paddle_tpu_torch.seed(1234)
        with torch.no_grad():
            again = layer(x, res)
        # the gradients equal autograd through the plain version with the
        # seed step 0 drew
        paddle_tpu_torch.seed(1234)
        seed0 = prng._bits_host(random.next_key())
        leaves = [t.detach().clone().requires_grad_() for t in (
            x, res, *layer.parameters())]
        ref = fr.fused_bias_dropout_residual_ln_ref(
            leaves[0].reshape(-1, d), leaves[2], leaves[1].reshape(-1, d),
            leaves[3], leaves[4], seed0, p, 1e-5, True)
        ref.backward(gout.reshape(-1, d))
        # relative to each leaf's largest gradient; the same ops on the same
        # inputs, so 0 is expected
        grad_err = max(((a.float() - b.grad.float()).abs().max()
                        / b.grad.float().abs().max().clamp_min(1e-30)).item()
                       for a, b in zip(grads[0], leaves))
        fwd_err = ((outs[0].reshape(-1, d).float() - ref.detach().float())
                   .abs() / ref.detach().float().abs().clamp_min(1.0)
                   ).max().item()
        eval_ref = fr.fused_bias_dropout_residual_ln_ref(
            x.detach().reshape(-1, d), layer.linear_bias.detach(),
            res.detach().reshape(-1, d), layer.ln_scale.detach(),
            layer.ln_bias.detach(), 0, p, 1e-5, False)
        eval_err = ((out_eval.reshape(-1, d).float() - eval_ref.float()).abs()
                    / eval_ref.float().abs().clamp_min(1.0)).max().item()
        kept = (outs[0] != outs[1]).float().mean().item()
        # CPU (plain) against the card (kernel): [64, 256] f32, and the hash
        # bits over rows past 2^16
        rng = np.random.default_rng(64)
        cut = [rng.standard_normal(s).astype(np.float32)
               for s in ((64, 256), (256,), (64, 256), (256,), (256,))]
        sides = [fr.fused_bias_dropout_residual_ln(
            *(torch.from_numpy(a).to(dev) for a in cut), p=0.3,
            training=True, seed=0xDEADBEEF).cpu() for dev in ("cpu", self.dev)]
        cut_err = (sides[0] - sides[1]).abs().max().item()
        rows = torch.arange(65500, 65600)
        hash_same = torch.equal(
            fr.hash_uniform(0xDEADBEEF, rows, 256),
            fr.hash_uniform(0xDEADBEEF, rows.to(self.dev), 256).cpu())
        line = dict(layer="FusedBiasDropoutResidualLayerNorm(2048, p=0.1)",
                    x=[B, S, d], dtype="bf16", steps=3,
                    step_ms=[round(t, 3) for t in times],
                    grad_norms=norms, fresh_masks=fresh,
                    same_masks_after_seed=torch.equal(again, outs[0]),
                    changed_share_between_steps=round(kept, 4),
                    max_grad_rel_err_vs_plain_autograd=grad_err,
                    grad_tol=1e-6,
                    max_fwd_err_vs_plain=fwd_err, max_eval_err_vs_plain=eval_err,
                    tol=FLN_TOL["bf16"], cpu_vs_card_f32_cut=cut_err,
                    cpu_vs_card_tol=1e-5, hash_bits_equal=hash_same)
        log("[incubate] " + json.dumps(line))
        if not (fresh and line["same_masks_after_seed"] and hash_same
                and grad_err <= 1e-6 and fwd_err <= FLN_TOL["bf16"]
                and eval_err <= FLN_TOL["bf16"] and cut_err <= 1e-5):
            raise AssertionError(f"incubate checks failed: {line}")
        paddle_tpu_torch.seed(0)
        del x, res, gout, outs, grads, leaves, ref
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- sampling
    def _sampling_profile(self, cfg, params, prompt, samp, steps=8):
        """Where a sampled decode step's time goes, beside a greedy one:
        ``steps`` steps of generate()'s loop (split, sample_logits,
        decode_one_token) under torch.profiler: wall with and without the
        profiler, device busy time, kernel launches a step, the host's
        synchronising CUDA calls and the operators with the most host
        time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch.framework import prng
        from paddle_tpu_torch.models import gpt
        B, P = prompt.shape
        tokens = torch.as_tensor(prompt, device=self.dev)
        kc, vc = gpt.init_kv_cache(cfg, B, P + 128, device=self.dev)
        first = gpt.prefill(params, cfg, tokens, kc, vc)[0]

        def run(kw):
            key, logits = prng.PRNGKey(0), first
            for i in range(steps):
                key, sub = prng.split(key)
                tok = gpt.sample_logits(logits, sub, **kw)
                logits, _, _ = gpt.decode_one_token(params, cfg, tok, P + i,
                                                    kc, vc)

        cuda = torch.autograd.DeviceType.CUDA
        sync_calls = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
        for tag, kw in (("greedy", dict(temperature=0.0)),
                        ("sampled", {k: v for k, v in samp.items()
                                     if k != "seed"})):
            run(kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(kw)
                torch.cuda.synchronize()
            busy_ms, _ = _device_rows(torch, prof, 0)
            rows = prof.key_averages()
            launches = sum(e.count for e in rows
                           if getattr(e, "device_type", None) == cuda)
            syncs = {e.key: e.count for e in rows if e.key in sync_calls}
            host = sorted((e for e in rows if e.key.startswith("aten::")),
                          key=lambda e: e.self_cpu_time_total,
                          reverse=True)[:6]
            log("[profile] " + json.dumps(dict(
                region=f"{tag} decode, {steps} steps of generate()'s loop",
                batch=B, prompt=P, wall_ms_unprofiled=round(plain_ms, 3),
                ms_per_step=round(plain_ms / steps, 3),
                device_busy_ms=round(busy_ms, 3),
                device_idle_share=round(1 - busy_ms / plain_ms, 4),
                kernel_launches_per_step=launches / steps,
                host_sync_calls=syncs,
                top_host=[dict(op=e.key, self_cpu_ms=round(
                    e.self_cpu_time_total / 1e3, 3), calls=e.count)
                    for e in host])))
        del kc, vc

    def phase_sampling(self):
        """Sampled decoding with the threefry PRNG: the known answers and
        bits/uniform on the card against the CPU, one categorical's launches
        and time, a full-width sampled generate() beside the greedy one, the
        12-request replay sampled, and sampled streams at 2 layers f32 equal
        on the CPU and the card."""
        torch = self.torch
        import numpy as np
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch.framework import prng
        from paddle_tpu_torch.models import gpt
        M = 0xFFFFFFFF
        known = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                 ((M, M), (M, M), (0x1CB996FC, 0xBB002BE7)),
                 ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                  (0xC4923A9C, 0x483DF7A0))]
        for key, (c0, c1), want in known:
            y = prng.threefry2x32(key, torch.tensor([c0], device=self.dev),
                                  torch.tensor([c1], device=self.dev))
            if (int(y[0]), int(y[1])) != want:
                raise AssertionError(f"threefry{key, (c0, c1)} on the card: "
                                     f"{int(y[0]):#x}, {int(y[1]):#x}")
        V, B = 50304, 4
        key = prng.PRNGKey(7)
        same_bits = torch.equal(prng.bits(key, (B, V), self.dev).cpu(),
                                prng.bits(key, (B, V), "cpu"))
        same_u = torch.equal(
            prng.uniform(key, (B, V), 1e-38, 1.0, self.dev).cpu().view(
                torch.int32),
            prng.uniform(key, (B, V), 1e-38, 1.0, "cpu").view(torch.int32))
        same_n = torch.equal(
            prng.normal(key, (B, V), device=self.dev).cpu().view(torch.int32),
            prng.normal(key, (B, V), device="cpu").view(torch.int32))
        # one full-width layer of init_params (gpt3_1p3b's last, bf16:
        # w_qkv, w_o, w_in, w_out at their counter offsets) drawn on the
        # card and on the CPU
        cfg, params = self._model()
        ks = prng.split(prng.PRNGKey(0), 10)
        layer = cfg.n_layers - 1
        t0 = time.perf_counter()
        same_layer = {}
        for name, shape in gpt._shapes(cfg)["blocks"].items():
            if name not in gpt._INIT_KEYS:
                continue
            draw = lambda dev: gpt.init_leaf(
                ks[gpt._INIT_KEYS[name]], shape, cfg, dev,
                (2 * cfg.n_layers) ** 0.5 if name in ("w_o", "w_out")
                else None, rows=range(layer, layer + 1))
            same_layer[name] = torch.equal(
                draw(self.dev).cpu().view(torch.int16),
                draw("cpu").view(torch.int16))
        log("[sampling] " + json.dumps(dict(
            normal_equal_cpu_card=same_n, init_layer=layer,
            init_layer_equal_cpu_card=same_layer,
            init_layer_cpu_s=round(time.perf_counter() - t0, 1))))
        if not (same_n and all(same_layer.values())):
            raise AssertionError("normal draws differ between CPU and card")
        logits = torch.randn((B, V), device=self.dev)
        prng.categorical(key, logits)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prng.categorical(key, logits)
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        launches = sum(e.count for e in prof.key_averages()
                       if getattr(e, "device_type", None) == cuda)
        cat_ms = self.time_ms(lambda: prng.categorical(key, logits), iters=20)
        cat_dev = self.device_ms(lambda: prng.categorical(key, logits))
        log("[sampling] " + json.dumps(dict(
            threefry_known_answers_on_card=True, bits_equal_cpu_card=same_bits,
            uniform_equal_cpu_card=same_u, categorical_shape=[B, V],
            categorical_kernel_launches=launches, categorical_ms=cat_ms,
            categorical_device_ms=cat_dev)))
        if not (same_bits and same_u and launches > 0):
            raise AssertionError("threefry bits differ between CPU and card")
        # full width: generate() sampled beside greedy, in this call
        L = cfg.n_layers
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (4, 256))
        N, samp = 32, dict(temperature=0.8, top_k=50, seed=0)
        gpt.generate(params, cfg, prompt[:2, :16], 2, device=self.dev, **samp)
        per_tok = {}
        for tag, kw in (("greedy", {}), ("sampled", samp)):
            t = []
            self._zero_counts()
            for n in (1, N):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = gpt.generate(params, cfg, prompt, n, device=self.dev,
                                   **kw)
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            counts = self._read_counts(f"sampling generate {tag}", (
                "flash_attention_fwd", "decode_attention"))
            self._expect_counts(f"sampling generate {tag}", counts, {
                "flash_attention_fwd": 2 * L,
                "decode_attention": L * (N - 1)})
            if out.shape != (4, 256 + N) or not bool(
                    ((out >= 0) & (out < cfg.vocab_size)).all()):
                raise AssertionError(f"{tag} generate output bad")
            per_tok[tag] = (t[1] - t[0]) / (N - 1) * 1e3
            if tag == "sampled":
                again = gpt.generate(params, cfg, prompt, N, device=self.dev,
                                     **kw)
                if not torch.equal(out, again):
                    raise AssertionError("sampled generate did not repeat")
        log("[sampling] " + json.dumps(dict(
            path="generate", batch=4, prompt=256, new_tokens=N, **samp,
            decode_ms_per_token_greedy=per_tok["greedy"],
            decode_ms_per_token_sampled=per_tok["sampled"],
            sampled_minus_greedy_ms=per_tok["sampled"] - per_tok["greedy"])))
        self._sampling_profile(cfg, params, prompt, samp)
        # the server's replay, sampled
        from paddle_tpu_torch.inference import GenerationSession
        sess = GenerationSession(params, cfg, max_slots=8, max_prompt_len=384,
                                 max_len=512, device=self.dev, **samp)
        _, line, counts = self._replay("sampled bf16 chunk=128", sess,
                                       self._server_trace(cfg), 128)
        self._expect_tick_counts(line["run"], counts, line, L,
                                 "decode_attention")
        del sess
        torch.cuda.empty_cache()
        # 2 layers, f32: the CPU and the card draw the same streams
        pcfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32)
        pprompt = np.random.default_rng(8).integers(0, pcfg.vocab_size,
                                                    (2, 64))
        weights = self._weights(pcfg)
        streams = [gpt.generate(weights[str(dev)], pcfg, pprompt, 16,
                                device=dev, **samp).cpu()
                   for dev in ("cpu", self.dev)]
        same = torch.equal(streams[0], streams[1])
        log("[sampling] " + json.dumps(dict(
            path="generate, gpt3_1p3b(n_layers=2, f32), B=2 x P=64 + 16",
            **samp, cpu_and_card_streams_equal=same)))
        if not same:
            raise AssertionError("sampled streams differ between the CPU "
                                 "and the card")

    # ------------------------------------------------------------- spec
    def _spec_instruments(self):
        """What this script lays over the model for the spec phase's
        margin rule: while ``self._capture`` names a lane ("on": the
        verify, "off": the plain tick), each such forward's logits beside
        the same forward on copies of the caches through the plain decode
        attention (the ticks run eagerly then: ``eager_ticks``). Returns
        (captured, undo)."""
        torch = self.torch
        from paddle_tpu_torch.inference import generation
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.ops.kernels import decode_attention as da
        captured = []
        attend = gpt.decode_attention
        verify, one = generation.verify_tokens, generation.decode_one_token

        def plain(q, kc, vc, pos, block=128, page_table=None):
            # the dense bf16 session of the margin rule only
            S = kc.shape[2]
            block = block if S % block == 0 else S
            return da.bounded_decode_attention(
                q, kc, vc, pos.long(), 1.0 / q.shape[-1] ** 0.5, block)

        def twin(fn, lane):
            def run(params, cfg, tokens, pos, kc, vc, *a, **kw):
                ref = None
                if self._capture == lane:
                    gpt.decode_attention = plain
                    ref = fn(params, cfg, tokens, pos, kc.clone(),
                             vc.clone(), *a, **kw)[0]
                    gpt.decode_attention = attend
                out = fn(params, cfg, tokens, pos, kc, vc, *a, **kw)
                if self._capture == lane:
                    captured.append((out[0], ref))
                return out
            return run

        generation.verify_tokens = twin(verify, "on")
        generation.decode_one_token = twin(one, "off")
        self._capture = None

        def undo():
            gpt.decode_attention = attend
            generation.verify_tokens, generation.decode_one_token = verify, one
        return captured, undo

    def _spec_streams(self, sess, prompt, N, captured):
        """Drive a session (spec on or off) over ``prompt`` until every row
        has N tokens; returns (streams [B][N], for each token the logits
        row that produced it and that row through the plain decode
        attention [B][N] as (kernel row, plain row) pairs; the first
        token's, the prefill's, has no plain row)."""
        torch = self.torch
        from paddle_tpu_torch.inference import eager_ticks
        spec = bool(sess.spec_k)
        self._capture = "on" if spec else "off"
        slots = sess.admit(prompt)
        out = {s: [] for s in slots}
        src = {s: [] for s in slots}
        prev = {s: (sess._logits[s].clone(), None) for s in slots}
        while any(len(out[s]) < N for s in slots):
            del captured[:]
            with eager_ticks():
                em = sess.spec_step() if spec else sess.step()
            lk, lp = captured[-1]
            for s, toks in em.items():
                toks = toks if isinstance(toks, list) else [toks]
                for j, t in enumerate(toks):
                    out[s].append(int(t))
                    src[s].append(prev[s] if j == 0
                                  else (lk[s, j - 1], lp[s, j - 1]))
                # the row the next tick's first token comes from: the
                # verify's after the last accepted token, or the tick's
                prev[s] = ((lk[s, len(toks) - 1], lp[s, len(toks) - 1])
                           if spec else (lk[s], lp[s]))
        self._capture = None
        sess.freeze(slots)
        for s in slots:
            sess.evict(s)
        torch.cuda.synchronize()
        return ([out[s][:N] for s in slots], [src[s][:N] for s in slots])

    def _margin_rule(self, off, on):
        """Spec-on greedy streams against spec-off ones at bf16. Over every
        token both streams share, and at the first one they do not: d, the
        largest difference between the spec-off logits row and the spec-on
        verify row that produced the position, and e, the largest
        difference between a kernel-path row and the same forward through
        the plain decode attention. A divergence is explained by rounding
        when the spec-off logits' top-two gap there is no larger than d;
        and every d stays within SPEC_D_LIMIT and every e within
        SPEC_E_LIMIT (PERF.md §6 has the readings these limits come from),
        so a verify that computes the wrong window fails even where the
        near-flat logits of random weights would explain any divergence.
        Returns one dict a row."""
        torch = self.torch
        diff = lambda a, b: float((a.float() - b.float()).abs().max())
        rows = []
        for b, ((s_off, l_off), (s_on, l_on)) in enumerate(zip(
                zip(*off), zip(*on))):
            i = next((i for i, (x, y) in enumerate(zip(s_off, s_on))
                      if x != y), None)
            n = len(s_off) if i is None else i + 1
            d = [diff(l_off[j][0], l_on[j][0]) for j in range(n)]
            e = [diff(r[0], r[1]) for r in l_off + l_on if r[1] is not None]
            row = dict(row=b, equal=i is None, d_max=max(d), e_max=max(e),
                       logits_abs_max=max(float(r[0].float().abs().max())
                                          for r in l_off[:n]))
            if i is not None:
                top = torch.topk(l_off[i][0].float(), 2).values
                row.update(first_diff=i, top2_gap=float(top[0] - top[1]),
                           max_logit_diff=d[i],
                           plain_diff=diff(l_off[i][1], l_on[i][1])
                           if l_on[i][1] is not None else None,
                           d_before=max(d[:i], default=0.0))
                row["explained"] = row["top2_gap"] <= d[i]
            row["within_limits"] = (row["d_max"] <= SPEC_D_LIMIT
                                    and row["e_max"] <= SPEC_E_LIMIT)
            rows.append(row)
        return rows

    def _spec_tick_profile(self, sess, prompt):
        """16 ticks of ``sess`` (B rows admitted; spec ticks, or plain ones
        with spec off) under torch.profiler: wall with and without the
        profiler, device busy time and idle share, and the split decode
        kernel's device time by window width (the verify's Q = k launches
        apart from the draft's Q = 1). Device activity only: reading the
        host's op events of 16 spec ticks took 30-36 s a profile."""
        import re
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        tick = sess.spec_step if sess.spec_k else sess.step
        slots = sess.admit(prompt)
        for _ in range(2):
            tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            tick()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(16):
                tick()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        for s in slots:
            sess.evict(s)
        t0 = time.perf_counter()
        busy_ms, top = _device_rows(torch, prof, 8)
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0))
        by_q = {}
        for e in prof.key_averages():
            m = re.search(r"split_decode_kernel<[^,]+, *\d+, *(\d+)", e.key)
            if m and dev_us(e) > 0:
                ms, n = by_q.get(int(m.group(1)), (0.0, 0))
                by_q[int(m.group(1))] = (ms + dev_us(e) / 1e3, n + e.count)
        line = dict(
            region=f"spec {'on' if sess.spec_k else 'off'} session, 16 "
                   "ticks", batch=len(slots),
            prompt=int(prompt.shape[1]), spec_k=sess.spec_k,
            wall_ms_unprofiled=round(plain_ms, 3),
            wall_ms_profiled=round(wall_ms, 3),
            trace_read_s=round(time.perf_counter() - t0, 1),
            device_busy_ms=round(busy_ms, 3),
            device_idle_share=round(1 - busy_ms / plain_ms, 4)
            if busy_ms else None,
            decode_kernel_by_q={str(q): dict(device_ms=round(ms, 4),
                                             launches=n,
                                             ms_per_launch=round(ms / n, 5))
                                for q, (ms, n) in sorted(by_q.items())},
            top=[dict(name=k[:60], ms=round(ms, 3), calls=c)
                 for k, ms, c in top])
        log("[profile] " + json.dumps(line))
        if (sess.spec_k or 1) not in by_q:
            raise AssertionError("the profile found no decode kernel of the "
                                 "tick's window width")
        return line

    def _spec_replay(self, tag, sess, sampled):
        """The server's 12-request trace through ServingEngine(
        prefill_chunk=128) on a spec session, counted: a warm-up request,
        then the trace with the counters zeroed just before and read just
        after. ``sampled``: every other request at temperature 0.8 with its
        own seed. Every request must end DONE with its budget."""
        torch = self.torch
        from paddle_tpu_torch.serving import RequestState, ServingEngine
        trace = self._server_trace(sess.cfg)
        eng = ServingEngine(sess, max_queue=64, prefill_chunk=128,
                            device=self.dev)
        eng.prewarm()           # the tick graphs, before the warm-up request
        warm = eng.submit(trace[0][0][:64], max_new_tokens=2)
        eng.run()
        if warm.state is not RequestState.DONE:
            raise AssertionError(f"{tag}: warm-up request did not finish")
        sess.reset_metrics()
        self._zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=m,
                           **(dict(temperature=0.8, seed=1000 + i)
                              if sampled and i % 2 == 0 else {}))
                for i, (p, m) in enumerate(trace)]
        eng.run(deadline=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for r, (_, m) in zip(reqs, trace):
            if r.state is not RequestState.DONE or len(r.output) != m:
                raise AssertionError(f"{tag} {r.request_id}: {r.state} with "
                                     f"{len(r.output)} of {m} tokens")
        counts = self._read_counts(tag, ())
        met = eng.metrics()
        toks = sum(len(r.output) for r in reqs)
        line = dict(run=tag, requests=len(reqs),
                    sampled_requests=sum(r.temperature > 0 for r in reqs),
                    spec_ticks=met["spec_ticks"],
                    suffix_prefills=met["prefill_chunks"], new_tokens=toks,
                    wall_s=round(wall, 3), tokens_per_s=round(toks / wall, 1),
                    spec_accept_rate=met["spec_accept_rate"],
                    spec_tokens_per_row_tick=met["spec_tokens_per_row_tick"],
                    spec_resample_total=met["spec_resample_total"],
                    ttft_ms_p50=met["ttft_ms_p50"],
                    decode_ms_per_token_p50=met["decode_ms_per_token_p50"])
        log("[spec] " + json.dumps(line))
        eng.close()
        return counts, line

    @staticmethod
    def _spec_cache_shape(sess, S):
        """The kernels phase holds the decode kernels at the spec phase's
        cache lengths; a session whose physical cache moved would leave
        them unchecked."""
        if sess._phys_len != S:
            raise AssertionError(f"spec session cache length "
                                 f"{sess._phys_len}, the kernels phase "
                                 f"checks {S}")

    def phase_spec(self):
        """Speculative decoding at full gpt3_1p3b width and at 2 layers f32
        on the CPU and the card (see the module doc)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.inference import GenerationSession
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        # a draw of its own: the train phase updates the shared weights in
        # place, and the draft's acceptance depends on the weights
        cfg = gpt.gpt3_1p3b()
        t_start = time.perf_counter()
        params = gpt.init_params(cfg, seed=0, device=self.dev)
        L, k, cut = cfg.n_layers, 4, cfg.n_layers // 2
        captured, undo = self._spec_instruments()
        marks = [("start", t_start), ("weights", time.perf_counter())]
        try:
            self._spec_full_width(cfg, params, L, k, cut, captured)
            marks.append(("generate", time.perf_counter()))
            # the replays: a separate draft (the first 4 layers as a model
            # of their own, with its own cache) serving half the requests
            # sampled, dense bf16; then w8kv8 on a paged pool with the
            # early-exit draft
            d4 = gpt.early_exit_draft(params, cfg, 4)
            sess = GenerationSession(params, cfg, max_slots=8,
                                     max_prompt_len=384, max_len=512,
                                     spec_decode=k, spec_draft=d4,
                                     spec_sample=True, device=self.dev)
            self._spec_cache_shape(sess, 640)
            tag = "spec bf16 separate draft (4 layers) chunk=128 sampled"
            counts, line = self._spec_replay(tag, sess, sampled=True)
            self._expect_counts(tag, counts, {
                "decode_attention": (k * 4 + L) * line["spec_ticks"]})
            marks.append(("replay bf16", time.perf_counter()))
            del sess, d4
            torch.cuda.empty_cache()
            qcfg = gpt.gpt3_1p3b(weight_quant="int8", kv_cache_dtype="int8")
            qp = quantize_gpt_params(params, qcfg, 8)
            sess = GenerationSession(qp, qcfg, max_slots=8,
                                     max_prompt_len=384, max_len=512,
                                     spec_decode=k, kv_paged=True,
                                     device=self.dev)
            self._spec_cache_shape(sess, 640)       # 5 pages of 128
            marks.append(("w8kv8 session", time.perf_counter()))
            tag = "spec w8kv8 paged early-exit chunk=128"
            counts, line = self._spec_replay(tag, sess, sampled=False)
            ticks, chunks = line["spec_ticks"], line["suffix_prefills"]
            self._expect_counts(tag, counts, {
                "decode_attention_paged_q8": ((k - 1) * cut + L) * ticks,
                "quant_matmul": 2 * ((k - 1) * cut + L) * ticks
                + 2 * L * chunks})
            # the draft's steps (M = 8 rows) on gemv, the verify (M = 8 x k)
            # and the chunks on the prefill form
            self._expect_routes(tag, {"gemv": 2 * (k - 1) * cut * ticks,
                                      "wgmma": 2 * L * (ticks + chunks)})
            marks.append(("replay w8kv8", time.perf_counter()))
            self._spec_tick_profile(sess, np.random.default_rng(0).integers(
                0, cfg.vocab_size, (8, 256)))
            marks.append(("profile w8kv8", time.perf_counter()))
            del sess, qp
            torch.cuda.empty_cache()
        finally:
            undo()
        self._spec_parity()
        marks.append(("parity", time.perf_counter()))
        log("[spec] seconds by part " + json.dumps({
            name: round(t - t0, 1)
            for (_, t0), (name, t) in zip(marks, marks[1:])}))

    def _spec_full_width(self, cfg, params, L, k, cut, captured):
        """generate-shaped runs at B=4 x P=256 (+32) through a session with
        the early-exit draft at its default cut, beside spec off: ms/token,
        acceptance, exact launches by Q a tick, the margin rule, and a
        profile of 16 spec ticks."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.inference import GenerationSession
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (4, 256))
        B, P = prompt.shape
        N = 32
        mk = lambda **kw: GenerationSession(
            params, cfg, max_slots=B, max_prompt_len=P, max_len=P + 192,
            device=self.dev, **kw)
        sessions = {"off": mk(), "on": mk(spec_decode=k)}
        if sessions["on"]._spec_cut != cut:
            raise AssertionError("the early-exit draft's default cut moved")
        self._spec_cache_shape(sessions["on"], 512)
        t_rule = time.perf_counter()
        # streams and the logits that produced every token
        streams = {t: self._spec_streams(s, prompt[:, :16], 2, captured)
                   for t, s in sessions.items()}          # warm-up
        streams = {t: self._spec_streams(s, prompt, N, captured)
                   for t, s in sessions.items()}
        rows = self._margin_rule(streams["off"], streams["on"])
        log("[spec] " + json.dumps(dict(
            margin_rule="spec-on greedy against spec-off, bf16, B=4 x P=256 "
                        "+ 32", d_limit=SPEC_D_LIMIT, e_limit=SPEC_E_LIMIT,
            rows=rows)))
        if not all((r["equal"] or r["explained"]) and r["within_limits"]
                   for r in rows):
            raise AssertionError(f"spec-on divergence unexplained or past "
                                 f"its limits: {rows}")
        del streams
        t_rule = time.perf_counter() - t_rule
        # the timed, counted runs
        per_tok, lines = {}, {}
        for tag, sess in sessions.items():
            sess.reset_metrics()
            self._zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slots = sess.admit(prompt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            while any(sess.generated_count(s) < N for s in slots):
                sess.spec_step() if sess.spec_k else sess.step()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for s in slots:
                sess.evict(s)
            met = sess.metrics()
            ticks = met["decode_ticks"]
            counts = self._read_counts(f"spec generate {tag}",
                                       ("flash_attention_fwd",
                                        "decode_attention"))
            per_tick = (k - 1) * cut + L if sess.spec_k else L
            self._expect_counts(f"spec generate {tag}", counts, {
                "flash_attention_fwd": L, "decode_attention": per_tick * ticks})
            want_q = ({1: (k - 1) * cut * ticks, k: L * ticks}
                      if sess.spec_k else {1: L * ticks})
            by_q = self._by_q()
            if by_q != want_q:
                raise AssertionError(f"spec generate {tag}: decode launches "
                                     f"by Q {by_q}, expected {want_q}")
            per_tok[tag] = (t2 - t1) / N * 1e3
            lines[tag] = dict(
                ticks=ticks, prefill_ms=round((t1 - t0) * 1e3, 3),
                decode_ms_per_token=round(per_tok[tag], 3),
                decode_launches_by_q_per_tick={
                    str(q): n // ticks for q, n in sorted(by_q.items())},
                spec_accept_rate=met["spec_accept_rate"],
                spec_tokens_per_row_tick=met["spec_tokens_per_row_tick"])
        log("[spec] " + json.dumps(dict(
            path="GenerationSession, gpt3_1p3b bf16", batch=B, prompt=P,
            new_tokens=N, spec_k=k, draft=f"early-exit, first {cut} layers",
            spec_on=lines["on"], spec_off=lines["off"],
            on_over_off=round(per_tok["on"] / per_tok["off"], 4),
            margin_rule_s=round(t_rule, 1))))
        # the same sessions' ticks, spec off and on, in one call
        for sess in sessions.values():
            self._spec_tick_profile(sess, prompt)
        del sessions
        torch.cuda.empty_cache()

    def _spec_parity(self):
        """gpt3_1p3b(n_layers=2, f32) on the numpy seed-0 weights, on the CPU
        and on the card: greedy spec streams (early-exit and separate draft,
        dense and paged) equal the spec-off stream on each device and
        across the two; sampled spec streams equal across the two; and the
        per-row key draws of the stochastic lane equal bitwise."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.framework import prng
        from paddle_tpu_torch.inference import GenerationSession
        from paddle_tpu_torch.models import gpt
        pcfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32)
        weights = self._weights(pcfg)
        prompt = np.random.default_rng(9).integers(0, pcfg.vocab_size,
                                                   (2, 64))
        N = 16
        greedy = {"early": dict(spec_draft_layers=1),
                  "draft": dict(draft=True),
                  "paged early": dict(spec_draft_layers=1, kv_paged=True),
                  "paged draft": dict(draft=True, kv_paged=True)}
        sampled = {"sampled early": dict(spec_draft_layers=1,
                                         temperature=0.8),
                   "sampled paged draft top-k": dict(
                       draft=True, kv_paged=True, temperature=1.0, top_k=50)}
        out = {}
        for dev in ("cpu", str(self.dev)):
            p = weights[dev]
            for tag, kw in [("off", None)] + list(greedy.items()) \
                    + list(sampled.items()):
                kw = dict(kw or {})
                if kw.pop("draft", False):
                    kw["spec_draft"] = gpt.early_exit_draft(p, pcfg, 1)
                if tag != "off":
                    kw["spec_decode"] = 4
                sess = GenerationSession(p, pcfg, max_slots=2,
                                         max_prompt_len=64, max_len=96,
                                         device=dev, **kw)
                out[(dev, tag)] = sess.generate(
                    prompt, max_new_tokens=N,
                    seeds=[3, 4] if sess.spec_sample else None)
        card = str(self.dev)
        res = {tag: dict(
            equal_spec_off=bool(np.array_equal(out[("cpu", tag)],
                                               out[("cpu", "off")])
                                and np.array_equal(out[(card, tag)],
                                                   out[(card, "off")])),
            equal_cpu_card=bool(np.array_equal(out[("cpu", tag)],
                                               out[(card, tag)])))
            for tag in greedy}
        res.update({tag: dict(equal_cpu_card=bool(np.array_equal(
            out[("cpu", tag)], out[(card, tag)]))) for tag in sampled})
        # the lane's per-row key draws over the vocabulary
        seeds = torch.tensor([0, 7, -1, 2 ** 31 - 1])
        pos = torch.tensor([1, 300, 2047, 64])
        draws = {}
        for dev in ("cpu", card):
            keys = gpt.spec_sample_key(seeds.to(dev), pos.to(dev),
                                       gpt.SPEC_LANE_DRAFT)
            lg = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (4, pcfg.vocab_size)).astype(np.float32)).to(dev)
            u = prng.uniform_rows(keys, (pcfg.vocab_size,))
            draws[dev] = (keys.cpu(), u.view(torch.int32).cpu(),
                          prng.categorical_rows(keys, lg).cpu())
        keys_equal = all(torch.equal(a, b)
                         for a, b in zip(draws["cpu"], draws[card]))
        log("[spec] " + json.dumps(dict(
            parity="gpt3_1p3b(n_layers=2, f32), B=2 x P=64 + 16, spec_k=4",
            streams=res, key_draws_equal_cpu_card=keys_equal)))
        if not keys_equal or not all(all(v.values()) for v in res.values()):
            raise AssertionError(f"spec parity failed: {res}, key draws "
                                 f"equal {keys_equal}")

    # ------------------------------------------------------------ graph
    def _graph_pair(self, params, cfg, max_len=448, **kw):
        """Two identical sessions, B=4 rows of 256-token prompts: one to
        run under eager_ticks(), one graphed."""
        from paddle_tpu_torch.inference import GenerationSession
        return tuple(GenerationSession(params, cfg, max_slots=4,
                                       max_prompt_len=256, max_len=max_len,
                                       device=self.dev, **kw)
                     for _ in range(2))

    def _state_diff(self, a, b) -> list:
        """The tick-state tensors and cache leaves of two sessions that
        differ in any bit. A paged pool's page 0 is left out: it is the
        scratch page, where dead rows' writes land together (one index
        store of several rows to one place, an arbitrary one winning) and
        which nothing reads."""
        torch = self.torch
        sa, sb = a._tick_state(), b._tick_state()
        bad = []
        for n, x in sa.items():
            y = sb[n]
            if a.kv_paged and n.startswith(("_kc", "_vc", "_dkc", "_dvc")):
                x, y = x[:, 1:], y[:, 1:]
            if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
                bad.append(n)
        return bad

    def _graph_case(self, tag, pair, prompt, lanes, ticks=16):
        """Feed an (eager, graphed) pair the same admissions (half the rows
        at tick 0, the rest at tick 6, so a page grant or a new row lands
        between replays) and hold every tick's emitted tokens, then the
        final logits, tick state and caches, bitwise equal."""
        import contextlib
        torch = self.torch
        from paddle_tpu_torch.inference import eager_ticks
        B = prompt.shape[0]
        runs = {}
        for name, sess in zip(("eager", "graphed"), pair):
            tick = sess.spec_step if sess.spec_k else sess.step
            out = []
            with (eager_ticks() if name == "eager"
                  else contextlib.nullcontext()):
                for t in range(ticks):
                    if t in (0, 6):
                        rows = slice(0, B // 2) if t == 0 else slice(B // 2, B)
                        sess.admit(prompt[rows], **{
                            k: v[rows] for k, v in lanes.items()})
                    out.append(tick())
            torch.cuda.synchronize()
            runs[name] = out
        eager, graphed = pair
        kind = "spec" if graphed.spec_k else "plain"
        graph = graphed._graphs.get(kind)
        if graph is None or not graph.captured or eager._graphs:
            raise AssertionError(f"{tag}: the graphed session captured no "
                                 "tick, or the eager one did")
        bad = self._state_diff(eager, graphed)
        same = runs["eager"] == runs["graphed"]
        toks = sum(len(v) if isinstance(v, list) else 1
                   for em in runs["graphed"] for v in em.values())
        log("[graph] " + json.dumps(dict(
            case=tag, batch=B, prompt=int(prompt.shape[1]), ticks=ticks,
            tokens=toks, streams_equal=same, state_and_caches_equal=not bad,
            differing=bad)))
        if not same or bad:
            raise AssertionError(f"{tag}: graphed ticks differ from eager "
                                 f"ones (streams equal {same}, differing "
                                 f"state {bad})")

    def _graph_tick_profile(self, tag, sess, prompt, graphed):
        """16 ticks of ``sess`` with B rows admitted and 2 ticks run
        first: the wall unprofiled; for a graphed session then 16 replays
        of its graph alone between CUDA events (the graphed tick's device
        time, whether or not the profiler sees a graph's kernels); then 16
        ticks under torch.profiler: device busy time, idle share against
        the unprofiled wall, the host-to-device and device-to-host copies.
        The profiler can lose a few records at the edges of its window, so
        a graphed session's 16 ticks run inside a ``record_function``
        range with two ticks on each side, and only the device records
        that start inside the range count (device activity alone for the
        eager session: reading its host ops would take half a minute)."""
        import contextlib
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile, record_function
        from paddle_tpu_torch.inference import eager_ticks
        tick = sess.spec_step if sess.spec_k else sess.step
        window = "graph_phase_16_ticks"
        with (contextlib.nullcontext() if graphed else eager_ticks()):
            slots = sess.admit(prompt)
            for _ in range(2):
                tick()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(16):
                tick()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            replay_ms = None
            if graphed:
                g = sess._graphs["spec" if sess.spec_k else "plain"]._graph
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(16):
                    g.replay()
                end.record()
                torch.cuda.synchronize()
                replay_ms = start.elapsed_time(end)
            acts = [ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if graphed else [])
            with profile(activities=acts) as prof:
                pad = 2 if graphed else 0
                for _ in range(pad):
                    tick()
                torch.cuda.synchronize()
                with record_function(window):
                    for _ in range(16):
                        tick()
                    torch.cuda.synchronize()
                for _ in range(pad):
                    tick()
                torch.cuda.synchronize()
        for s in slots:
            sess.evict(s)
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.events()
        dev = [e for e in events
               if e.device_type == cuda and e.name != window]
        if graphed:
            rng = next(e.time_range for e in events if e.name == window
                       and e.device_type != cuda)
            dev = [e for e in dev
                   if rng.start <= e.time_range.start <= rng.end]
        by_name: dict = {}
        for e in dev:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy_ms = sum(ms for ms, _ in by_name.values())
        copies = {d: sum(n for k, (_, n) in by_name.items()
                         if k.startswith(f"Memcpy {d}"))
                  for d in ("HtoD", "DtoH")}
        # the host's copy calls in the range, on the range's own clock: the
        # device's records of a tick can be lost at the window's edge
        calls = None
        if graphed:
            calls = sum(1 for e in events if e.device_type != cuda
                        and e.name in ("cudaMemcpyAsync", "cudaMemcpy")
                        and rng.start <= e.time_range.start <= rng.end)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        line = dict(
            region=f"{tag}, 16 ticks, {'graphed' if graphed else 'eager'}",
            batch=len(slots), prompt=int(prompt.shape[1]),
            wall_ms=round(wall_ms, 3),
            device_busy_ms_profiler=round(busy_ms, 3),
            device_idle_share=round(1 - busy_ms / wall_ms, 4),
            replay_device_ms_events=round(replay_ms, 3)
            if replay_ms is not None else None,
            h2d_copies=copies["HtoD"], d2h_copies=copies["DtoH"],
            copy_calls=calls,
            top=[dict(name=k[:60], ms=round(ms, 3), calls=n)
                 for k, (ms, n) in top])
        log("[graph] " + json.dumps(line))
        # 16 copy calls, one a tick (its tokens, device to host), and no
        # device record of a host-to-device copy
        if graphed and (copies["HtoD"] or calls != 16):
            raise AssertionError(f"{tag}: 16 graphed ticks made {calls} copy "
                                 f"calls and {copies['HtoD']} host-to-device "
                                 "copies (want 16 and 0)")
        return line

    def _graph_generate(self, cfg, params, prompt, N=32):
        """generate() on B=4 x P=256 (+N), greedy and sampled, graphed
        against eager: the outputs bitwise equal, decode ms a token each
        ((t(N) - t(1)) / (N - 1), the capture included)."""
        import contextlib
        torch = self.torch
        from paddle_tpu_torch.inference import eager_ticks
        from paddle_tpu_torch.models import gpt
        B, P = prompt.shape
        for tag, kw in (("greedy", {}),
                        ("sampled", dict(temperature=0.8, top_k=50, seed=0))):
            res = {}
            for name in ("eager", "graphed"):
                with (eager_ticks() if name == "eager"
                      else contextlib.nullcontext()):
                    gpt.generate(params, cfg, prompt[:2, :16], 3,
                                 device=self.dev, **kw)
                    t = []
                    for n in (1, N):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        out = gpt.generate(params, cfg, prompt, n,
                                           device=self.dev, **kw)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter() - t0)
                res[name] = (out, (t[1] - t[0]) / (N - 1) * 1e3)
            same = torch.equal(res["eager"][0], res["graphed"][0])
            log("[graph] " + json.dumps(dict(
                path=f"generate {tag}", batch=B, prompt=P, new_tokens=N, **kw,
                decode_ms_per_token_eager=round(res["eager"][1], 3),
                decode_ms_per_token_graphed=round(res["graphed"][1], 3),
                outputs_equal=same)))
            if not same:
                raise AssertionError(f"generate {tag}: graphed output "
                                     "differs from eager")

    def phase_graph(self):
        """The serving steps as captured CUDA graphs at full gpt3_1p3b
        width (see the module doc)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        cfg, params = self._model()
        qcfg = gpt.gpt3_1p3b(weight_quant="int8", kv_cache_dtype="int8")
        qp = quantize_gpt_params(params, qcfg, 8)
        d4, dq4 = (gpt.early_exit_draft(params, cfg, 4),
                   gpt.early_exit_draft(qp, qcfg, 4))
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (4, 256))
        lanes = dict(temperatures=np.array([0.8, 1.0, 0.0, 0.7]),
                     seeds=np.array([11, 12, 13, 14]))
        samp = dict(temperature=0.8, top_k=50)
        cases = [
            ("plain greedy dense bf16", params, cfg, {}),
            ("plain sampled paged bf16", params, cfg,
             dict(kv_paged=True, **samp)),
            ("plain greedy paged w8kv8", qp, qcfg, dict(kv_paged=True)),
            ("plain sampled dense w8kv8", qp, qcfg, samp),
            ("spec k=4 early-exit greedy dense bf16", params, cfg,
             dict(spec_decode=4)),
            ("spec k=4 separate draft stochastic paged bf16", params, cfg,
             dict(spec_decode=4, spec_draft=d4, kv_paged=True, **samp)),
            ("spec k=4 early-exit stochastic paged w8kv8", qp, qcfg,
             dict(spec_decode=4, kv_paged=True, **samp)),
            ("spec k=4 separate draft greedy dense w8kv8", qp, qcfg,
             dict(spec_decode=4, spec_draft=dq4)),
        ]
        self._zero_counts()
        for tag, p, c, kw in cases:
            pair = self._graph_pair(p, c, **kw)
            self._graph_case(tag, pair, prompt,
                             lanes if pair[1].spec_sample else {})
            del pair
            torch.cuda.empty_cache()
        self._read_counts("graph", (
            "decode_attention", "decode_attention_q8",
            "decode_attention_paged", "decode_attention_paged_q8",
            "quant_matmul"))
        self._graph_generate(cfg, params, prompt)
        # 16 ticks, eager against graphed in this call
        for tag, p, c, kw in (("plain bf16", params, cfg, {}),
                              ("plain w8kv8", qp, qcfg, {}),
                              ("spec k=4 early-exit bf16", params, cfg,
                               dict(spec_decode=4))):
            eager, graphed = self._graph_pair(p, c, max_len=640, **kw)
            self._graph_tick_profile(tag, eager, prompt, False)
            self._graph_tick_profile(tag, graphed, prompt, True)
            del eager, graphed
            torch.cuda.empty_cache()
        del qp, d4, dq4
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ buckets
    def _tick_spy(self, sess, ticks, label=None):
        """Wrap the session's tick calls: each appends (kind, width, wall
        s, host-to-device copies it owes) to ``ticks``; ``label`` opens a
        profiler range named ``label(i)`` around tick i. A chunk tick owes
        its packed batch, a decode tick its dump positions when they
        changed, either the page tables when an admission changed them.
        Returns the undo."""
        import contextlib
        from torch.profiler import record_function
        kinds = {"step": "decode", "spec_step": "decode",
                 "fused_tick": "fused", "spec_tick": "spec_fused",
                 "prefill_chunks": "chunk"}
        for name, kind in kinds.items():
            fn = getattr(sess, name)

            def spy(*a, _fn=fn, _kind=kind, **kw):
                owed = (1 if _kind != "decode" else int(sess._dump_dirty)) \
                    + int(sess.kv_paged and sess._ptab_dirty)
                rng = (record_function(label(len(ticks))) if label
                       else contextlib.nullcontext())
                t0 = time.perf_counter()
                with rng:
                    out = _fn(*a, **kw)
                ticks.append((_kind, a[1] if a else None,
                              time.perf_counter() - t0, owed))
                return out
            setattr(sess, name, spy)
        return lambda: [delattr(sess, n) for n in kinds]

    def _bucket_run(self, tag, sess, trace, ekw, graphed, background=False):
        """One replay of ``trace`` through ServingEngine(**ekw): for the
        graphed session prewarm() first (timed; in a thread with
        ``background``), then a warm-up request, then the trace submitted
        at once, drained, with the counters zeroed just before and read
        just after (graphed). Returns (streams, line, ticks)."""
        import contextlib
        torch = self.torch
        from paddle_tpu_torch.inference import eager_ticks
        from paddle_tpu_torch.serving import RequestState, ServingEngine
        eng = ServingEngine(sess, max_queue=64, device=self.dev, **ekw)
        line = dict(run=tag, mode="graphed" if graphed else "eager")
        with (contextlib.nullcontext() if graphed else eager_ticks()):
            t0 = time.perf_counter()
            if graphed:
                out = eng.prewarm(background=background)
                if not background:
                    line["prewarm"] = out
            warm = eng.submit(trace[0][0][:64], max_new_tokens=2)
            eng.run()
            torch.cuda.synchronize()
            if graphed:
                line["prewarm_s" if not background else
                     "prewarm_in_background_and_warm_up_s"] = round(
                         time.perf_counter() - t0, 3)
            if warm.state is not RequestState.DONE:
                raise AssertionError(f"{tag}: warm-up request did not finish")
            sess.reset_metrics()
            ticks = []
            undo = self._tick_spy(sess, ticks)
            if graphed:
                self._zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [eng.submit(p, max_new_tokens=m) for p, m in trace]
            eng.run(deadline=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            undo()
        for r, (_, m) in zip(reqs, trace):
            if r.state is not RequestState.DONE or len(r.output) != m:
                raise AssertionError(f"{tag} {r.request_id}: {r.state} with "
                                     f"{len(r.output)} of {m} tokens")
        met = eng.metrics()
        toks = sum(len(r.output) for r in reqs)
        by_kind: dict = {}
        for kind, w, dt, _ in ticks:
            key = kind if w is None else f"{kind}@{w}"
            n, s = by_kind.get(key, (0, 0.0))
            by_kind[key] = (n + 1, s + dt)
        line.update(
            requests=len(reqs), new_tokens=toks, wall_s=round(wall, 3),
            tokens_per_s=round(toks / wall, 1),
            ttft_ms_p50=met["ttft_ms_p50"], ttft_ms_p99=met["ttft_ms_p99"],
            decode_ms_per_token_p50=met["decode_ms_per_token_p50"],
            chunk_ticks=met["prefill_chunks"], decode_ticks=met["decode_ticks"],
            tick_wall_ms={k: dict(ticks=n, mean=round(s / n * 1e3, 3))
                          for k, (n, s) in sorted(by_kind.items())})
        if eng.prefix_cache is not None:
            line["prefix_hit_tokens"] = sum(r.prefix_hit_tokens for r in reqs)
        if graphed:
            line["counts"] = self._read_counts(f"buckets {tag}", ())
            # prewarm() brought up every graph the replay ran, and no other
            tick = "spec_fused" if sess.spec_k else "fused"
            want = {"spec" if sess.spec_k else "plain"} | {
                (kind, w) for w in eng.width_buckets
                for kind in ("chunk", tick)}
            if set(sess._graphs) != want or not all(
                    g.captured for g in sess._graphs.values()):
                raise AssertionError(
                    f"{tag}: graphs {sorted(map(str, sess._graphs))}, "
                    f"prewarm() should have captured {sorted(map(str, want))}")
            line["graphs"] = len(sess._graphs)
            line["graph_pool_mib"] = round(sum(
                g.pool_bytes for g in sess._graphs.values()) / 2 ** 20, 1)
            line["graph_pool_mib_by_graph"] = {
                str(k): round(g.pool_bytes / 2 ** 20, 1)
                for k, g in sess._graphs.items()}
        eng.close()
        while eng.prefix_cache is not None and len(eng.prefix_cache):
            eng.prefix_cache._evict_one()
        return [list(r.output) for r in reqs], line, ticks

    def _bucket_profile(self, tag, sess, trace, ekw):
        """Four requests of ``trace`` through the graphed session under
        torch.profiler, each tick in a range of its own: per tick kind
        and width, the ticks, host wall and device time (kernels and
        copies that start inside the range) a tick, its six largest
        kernels, and the CUDA copy calls the host made in the range, held
        exactly to the host-to-device copies the tick owes
        (:meth:`_tick_spy`) plus the one device-to-host copy of its
        result."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch.serving import ServingEngine
        eng = ServingEngine(sess, max_queue=64, device=self.dev, **ekw)
        ticks = []
        label = lambda i: f"bucket_tick_{i}"
        undo = self._tick_spy(sess, ticks, label)
        pad = torch.ones((1024,), device=self.dev)

        def padding():
            # device work on either side of the ticks: the profiler drops
            # records at the edges of its window
            for _ in range(8):
                pad.mul_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.05)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            padding()
            for p, m in trace[:4]:
                eng.submit(p, max_new_tokens=min(m, 8))
            eng.run(deadline=300)
            torch.cuda.synchronize()
            padding()
        undo()
        eng.close()
        while eng.prefix_cache is not None and len(eng.prefix_cache):
            eng.prefix_cache._evict_one()
        import bisect
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.events()
        ranges = {e.name: e.time_range for e in events
                  if e.device_type != cuda and e.name.startswith(
                      "bucket_tick_")}
        dev = sorted(((e.time_range.start, e.time_range.elapsed_us(), e.name)
                      for e in events if e.device_type == cuda
                      and not e.name.startswith("bucket_tick_")))
        # the host's copy calls: on the host's clock, like the ranges (the
        # device's copy records may fall into a neighbouring tick's range)
        calls = sorted(e.time_range.start for e in events
                       if e.device_type != cuda
                       and e.name in ("cudaMemcpyAsync", "cudaMemcpy"))
        starts = [d[0] for d in dev]
        table: dict = {}
        bad = []
        for i, (kind, w, _, owed) in enumerate(ticks):
            rng = ranges.get(label(i))
            if rng is None:
                continue        # the profiler lost the range
            lo = bisect.bisect_left(starts, rng.start)
            hi = bisect.bisect_right(starts, rng.end)
            inside = dev[lo:hi]
            # a tick's copies: those it owes in, one out (the tokens)
            copies = bisect.bisect_right(calls, rng.end) \
                - bisect.bisect_left(calls, rng.start)
            if copies != owed + 1:
                bad.append((i, kind, w, copies, owed + 1))
            key = kind if w is None else f"{kind}@{w}"
            row = table.setdefault(key, dict(ticks=0, wall_ms=0.0,
                                             device_ms=0.0, h2d=0,
                                             copy_calls=0, top={}))
            row["ticks"] += 1
            row["wall_ms"] += rng.elapsed_us() / 1e3
            row["device_ms"] += sum(us for _, us, _ in inside) / 1e3
            row["h2d"] += owed
            row["copy_calls"] += copies
            for _, us, n in inside:
                row["top"][n] = row["top"].get(n, 0.0) + us / 1e3
        for row in table.values():
            for k in ("wall_ms", "device_ms"):
                row[k] = round(row[k] / row["ticks"], 3)
            # where a tick's device time goes: the six largest kernels
            row["top"] = [dict(name=n[:60], ms=round(ms / row["ticks"], 3))
                          for n, ms in sorted(row["top"].items(),
                                              key=lambda kv: -kv[1])[:6]]
        log("[buckets] " + json.dumps(dict(
            profile=tag, ticks_seen=sum(r["ticks"] for r in table.values()),
            ticks=len(ticks), copy_calls_seen=len(calls),
            by_tick=dict(sorted(table.items())))))
        if bad or not calls:
            raise AssertionError(
                f"{tag}: ticks whose copy calls differ from the copies in "
                f"they owe plus one out (tick, kind, width, calls, owed): "
                f"{bad[:8]}; {len(calls)} copy calls recorded")
        return table

    def phase_buckets(self):
        """Width buckets and prefill batching at full gpt3_1p3b width (see
        the module doc)."""
        torch = self.torch
        from paddle_tpu_torch.inference import GenerationSession
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        cfg, params = self._model()
        L, k, cut = cfg.n_layers, 4, cfg.n_layers // 2
        trace = self._server_trace(cfg)
        pr12 = {0: dict(ttft_ms_p50=61.5, tokens_per_s=937.1),
                128: dict(ttft_ms_p50=145.6, tokens_per_s=662.3)}
        qcfg = gpt.gpt3_1p3b(weight_quant="int8", kv_cache_dtype="int8")
        runs = [
            ("bf16 dense chunk=128 buckets=(32,64) min_batch=6 defer=4",
             params, cfg, {}, trace,
             dict(prefill_chunk=128, width_buckets=(32, 64),
                  prefill_min_batch=6, prefill_max_defer=4), False),
            ("bf16 dense whole-prompt buckets=(64,128,256)", params, cfg, {},
             trace, dict(width_buckets=(64, 128, 256)), False),
            ("bf16 paged shared-prefix reuse buckets=(32,64,128)", params, cfg,
             dict(kv_paged=True), self._shared_prefix_trace(cfg),
             dict(prefix_cache_blocks=16, width_buckets=(32, 64, 128)), True),
            ("w8kv8 paged spec k=4 early-exit chunk=128 buckets=(32,64)",
             None, qcfg, dict(kv_paged=True, spec_decode=k), trace,
             dict(prefill_chunk=128, width_buckets=(32, 64)), False),
        ]
        summary = []
        for tag, p, c, skw, tr, ekw, background in runs:
            if p is None:
                p = quantize_gpt_params(params, qcfg, 8)
            pair = [GenerationSession(p, c, max_slots=8, max_prompt_len=384,
                                      max_len=512, device=self.dev, **skw)
                    for _ in range(2)]
            eager_out, eager_line, _ = self._bucket_run(
                tag, pair[0], tr, ekw, graphed=False)
            out, line, ticks = self._bucket_run(tag, pair[1], tr, ekw,
                                                graphed=True,
                                                background=background)
            bad = self._state_diff(*pair)
            line.update(streams_equal=out == eager_out,
                        state_and_caches_equal=not bad, differing=bad,
                        eager=dict(tokens_per_s=eager_line["tokens_per_s"],
                                   ttft_ms_p50=eager_line["ttft_ms_p50"]))
            if tag.startswith("bf16 dense"):
                line["pr12_same_trace_without_buckets"] = pr12[
                    ekw.get("prefill_chunk", 0)]
            counts = line.pop("counts")
            log("[buckets] " + json.dumps(line))
            if out != eager_out or bad:
                raise AssertionError(f"{tag}: graphed replay differs from "
                                     f"eager (streams equal "
                                     f"{out == eager_out}, state {bad})")
            ticks_n, chunks_n = line["decode_ticks"], line["chunk_ticks"]
            if "spec" in tag:
                spec_ticks = sum(1 for t in ticks if t[0] != "chunk")
                self._expect_counts(tag, counts, {
                    "decode_attention_paged_q8":
                        ((k - 1) * cut + L) * spec_ticks,
                    "quant_matmul": 2 * ((k - 1) * cut + L) * spec_ticks
                    + 2 * L * chunks_n})
                self._expect_routes(tag, {
                    "gemv": 2 * (k - 1) * cut * spec_ticks,
                    "wgmma": 2 * L * (spec_ticks + chunks_n)})
            else:
                self._expect_counts(tag, counts, {
                    "decode_attention_paged" if skw.get("kv_paged")
                    else "decode_attention": L * ticks_n})
            self._bucket_profile(tag, pair[1], tr, ekw)
            summary.append(dict(run=tag, ttft_ms_p50=line["ttft_ms_p50"],
                                tokens_per_s=line["tokens_per_s"],
                                graph_pool_mib=line["graph_pool_mib"]))
            del pair, p
            torch.cuda.empty_cache()
        log("[buckets] " + json.dumps(dict(summary=summary)))


    # ------------------------------------------------ streams across paths
    def _flip_finding(self, params, cfg, prompt, agreed):
        """Why two greedy streams part after ``agreed`` (the tokens both
        emitted): the next position's logits through a prefill of the
        prompt and one decode step a token (A, K/V of the generated tokens
        written by decode steps, as in an uninterrupted run), and through
        one prefill of prompt + agreed (B, written by a prefill, as in a
        resume, a replay or a handoff). Returns the top-two gap of A, d =
        max|A - B|, and the GEMM kernels each path ran."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch.models import gpt
        prompt = torch.as_tensor(prompt, device=self.dev).long()[None]
        agreed = torch.as_tensor(agreed, device=self.dev).long()
        n = prompt.shape[1] + agreed.shape[0]
        cache = lambda: gpt.init_kv_cache(cfg, 1, gpt.pad_cache_len(
            n + 1, cfg.decode_block), device=self.dev)
        kernels = {}
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            kc, vc = cache()
            a, _, _ = gpt.prefill(params, cfg, prompt, kc, vc)
            for i, t in enumerate(agreed.tolist()):
                a, _, _ = gpt.decode_one_token(
                    params, cfg, torch.tensor([t], device=self.dev),
                    prompt.shape[1] + i, kc, vc)
            torch.cuda.synchronize()
        kernels["decode_path"] = sorted({e.key[:48] for e in p.key_averages()
                                         if "gemm" in e.key.lower()
                                         or "nvjet" in e.key})
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            kc, vc = cache()
            b, _, _ = gpt.prefill(params, cfg, torch.cat(
                [prompt, agreed[None]], 1), kc, vc)
            torch.cuda.synchronize()
        kernels["prefill_path"] = sorted({e.key[:48] for e in p.key_averages()
                                          if "gemm" in e.key.lower()
                                          or "nvjet" in e.key})
        top = torch.topk(a[0].float(), 2).values
        return dict(position=int(agreed.shape[0]),
                    top2_gap=float(top[0] - top[1]),
                    d=float((a.float() - b.float()).abs().max()),
                    gemm_kernels=kernels)

    def _streams_check(self, tag, params, cfg, prompts, want, got):
        """Greedy streams of two serving paths over the same prompts:
        equal, or each pair parted where a rounding flip explains it (PR
        11's margin rule): at the first differing position the
        uninterrupted path's top-two gap is no larger than d, the
        difference between a decode-written and a prefill-written context
        (_flip_finding), and d stays within SPEC_D_LIMIT. Anything else
        fails. Returns a summary with every finding."""
        findings = []
        for i, (p, a, b) in enumerate(zip(prompts, want, got)):
            if a == b:
                continue
            if len(a) != len(b):
                raise AssertionError(f"{tag}: request {i} has {len(b)} "
                                     f"tokens, the reference {len(a)}")
            j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            f = self._flip_finding(params, cfg, p, a[:j])
            f.update(request=i, tokens=(a[j], b[j]))
            f["explained"] = f["top2_gap"] <= f["d"] <= SPEC_D_LIMIT
            findings.append(f)
        out = dict(equal=len(want) - len(findings), of=len(want),
                   findings=findings)
        if not all(f["explained"] for f in findings):
            raise AssertionError(f"{tag}: streams part without a rounding "
                                 f"flip to explain it: {json.dumps(out)}")
        return out

    # ------------------------------------------------------------ resil
    def _plane_run(self, tag, sess, trace, ekw, tenants=False):
        """The 12-request replay through ServingEngine(**ekw) on ``sess``
        (prewarmed, a warm-up request, the counters and the meter reset,
        then the trace at once, request ids r0..r11, each with a tenant
        when ``tenants``). Returns (streams, tick kinds, polls, line)."""
        torch = self.torch
        from paddle_tpu_torch.serving import RequestState, ServingEngine
        eng = ServingEngine(sess, max_queue=64, device=self.dev, **ekw)
        eng.prewarm()
        warm = eng.submit(trace[0][0][:64], max_new_tokens=2,
                          request_id="warm")
        eng.run()
        if warm.state is not RequestState.DONE:
            raise AssertionError(f"{tag}: warm-up request did not finish")
        sess.reset_metrics()
        if eng.meter is not None:
            eng.meter.reset()
        ticks = []
        undo = self._tick_spy(sess, ticks)
        self._zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=m, request_id=f"r{i}",
                           **({"tenant": f"tenant{i % 3}"} if tenants
                              else {}))
                for i, (p, m) in enumerate(trace)]
        polls = eng.run(deadline=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        undo()
        counts = self._read_counts(f"resil {tag}", ("decode_attention",))
        for r, (_, m) in zip(reqs, trace):
            if r.state is not RequestState.DONE or len(r.output) != m:
                raise AssertionError(f"{tag} {r.request_id}: {r.state} with "
                                     f"{len(r.output)} of {m} tokens")
        met = eng.metrics()
        toks = sum(len(r.output) for r in reqs)
        line = dict(run=tag, requests=len(reqs), new_tokens=toks,
                    polls=polls, ticks=len(ticks), wall_s=round(wall, 4),
                    ms_per_poll=round(wall / polls * 1e3, 3),
                    tokens_per_s=round(toks / wall, 1),
                    ttft_ms_p50=met["ttft_ms_p50"],
                    ttft_ms_p99=met["ttft_ms_p99"],
                    decode_attention=counts["decode_attention"])
        if eng.meter is not None:
            totals = eng.meter.totals()
            line["meter"] = dict(decode_tokens=totals["decode_tokens"],
                                 prefill_tokens=totals["prefill_tokens"],
                                 tokens_emitted=met["tokens_emitted"],
                                 tenants=len(eng.meter.tenants()))
            if totals["decode_tokens"] != met["tokens_emitted"]:
                raise AssertionError(f"{tag}: metered decode tokens "
                                     f"{totals['decode_tokens']} != "
                                     f"{met['tokens_emitted']} emitted")
        eng.close()
        return ([list(r.output) for r in reqs],
                [(k, w) for k, w, _, _ in ticks], polls, line)

    def phase_resil(self):
        """The resilience, metering and tracing planes at full width on
        the buckets phase's chunk=128 replay (see the module doc)."""
        torch = self.torch
        import os
        import tempfile
        from paddle_tpu_torch.distributed.ft.chaos import ChaosPlan
        from paddle_tpu_torch.observability import tracing
        from paddle_tpu_torch.serving import (RequestJournal, RequestState,
                                              ResiliencePolicy, ServingEngine,
                                              replay_journal)
        cfg, params = self._model()
        trace = self._server_trace(cfg)
        ekw = dict(RESIL_ENGINE)
        sess = self._session(params, cfg, paged=False)
        base, base_ticks, polls, line = self._plane_run("plain", sess, trace,
                                                        ekw)
        graphs = {k: id(g) for k, g in sess._graphs.items()}
        lines = [line]
        log("[resil] " + json.dumps(line))
        # (a) resilience armed, no fault; (c) metering with tenants,
        # tracing, and all three at once
        os.environ.pop("PADDLE_TPU_TRACING", None)
        for tag, kw, traced in (
                ("resilience", dict(resilience=ResiliencePolicy(
                    chaos=ChaosPlan())), False),
                ("metering", dict(metering=True), False),
                ("tracing", {}, True),
                ("all_planes", dict(resilience=ResiliencePolicy(
                    chaos=ChaosPlan()), metering=True), True)):
            if traced:
                os.environ["PADDLE_TPU_TRACING"] = "1"
                tracing.reset()
            try:
                out, ticks, n, line = self._plane_run(
                    tag, sess, trace, dict(ekw, **kw),
                    tenants="metering" in kw)
            finally:
                os.environ.pop("PADDLE_TPU_TRACING", None)
            if traced:
                line["spans"] = len(tracing.records())
                line["live_traces_after_close"] = tracing.live_count()
                tracing.reset()
            same = dict(streams=out == base, ticks=ticks == base_ticks,
                        polls=n == polls,
                        graphs={k: id(g) for k, g in sess._graphs.items()}
                        == graphs)
            line["equal_to_plain"] = same
            lines.append(line)
            log("[resil] " + json.dumps(line))
            if not all(same.values()):
                raise AssertionError(f"resil {tag}: differs from the plain "
                                     f"engine: {same}")
        # (b) a child replays with the journal and dies at poll N (SIGKILL
        # from the chaos plan); a fresh engine here replays the journal
        kill_at = polls // 2
        with tempfile.TemporaryDirectory() as tmp:
            torch.save(params, os.path.join(tmp, "params.pt"))
            env = dict(os.environ, PADDLE_TPU_CHAOS=f"kill@tick={kill_at}")
            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--resil-child", tmp], env=env, capture_output=True,
                text=True, timeout=600)
            child_s = time.perf_counter() - t0
            if child.returncode != -9:
                raise AssertionError(
                    f"resil crash child exited {child.returncode}, not -9 "
                    f"(SIGKILL at poll {kill_at}): {child.stderr[-2000:]}")
            path = os.path.join(tmp, "journal.jsonl")
            before = RequestJournal.scan(path)
            eng = ServingEngine(sess, max_queue=64, device=self.dev,
                                resilience=ResiliencePolicy(
                                    chaos=ChaosPlan(), journal_path=path),
                                **ekw)
            t0 = time.perf_counter()
            resumed = replay_journal(eng, path)
            eng.run(deadline=600)
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t0
            eng.close()
            after = RequestJournal.scan(path)
        if any(r.state is not RequestState.DONE for r in resumed) or \
                set(after) != {f"r{i}" for i in range(len(trace))} or \
                any(e["state"] != "done" for e in after.values()):
            raise AssertionError(f"resil replay lost requests: "
                                 f"{ {k: e['state'] for k, e in after.items()} }")
        got = [after[f"r{i}"]["out"] for i in range(len(trace))]
        line = dict(run="crash_replay", kill_at_poll=kill_at, of_polls=polls,
                    child_returncode=child.returncode,
                    child_s=round(child_s, 2),
                    journaled=len(before),
                    done_before_kill=sum(1 for e in before.values()
                                         if e["state"] == "done"),
                    resumed=len(resumed),
                    resumed_with_tokens=sum(1 for r in resumed
                                            if r.resumed_len),
                    replay_s=round(replay_s, 3))
        line["streams"] = self._streams_check(
            "resil crash replay", params, cfg, [p for p, _ in trace], base,
            got)
        log("[resil] " + json.dumps(line))
        log("[resil] " + json.dumps(dict(summary=[
            dict(run=x["run"], tokens_per_s=x["tokens_per_s"],
                 ttft_ms_p50=x["ttft_ms_p50"], ms_per_poll=x["ms_per_poll"])
            for x in lines])))

    def resil_child(self, tmp):
        """The crash victim of phase_resil (a process of its own): the same
        replay on the same weights with the crash journal, under the
        PADDLE_TPU_CHAOS plan its parent set (kill@tick=N). Returns only
        if the plan never fired."""
        import os
        from paddle_tpu_torch.serving import ResiliencePolicy, ServingEngine
        torch = self.torch
        params = torch.load(os.path.join(tmp, "params.pt"),
                            map_location=self.dev)
        from paddle_tpu_torch.models import gpt
        cfg = gpt.gpt3_1p3b()
        sess = self._session(params, cfg, paged=False)
        eng = ServingEngine(sess, max_queue=64, device=self.dev,
                            resilience=ResiliencePolicy(journal_path=os.path.join(
                                tmp, "journal.jsonl")), **RESIL_ENGINE)
        eng.prewarm()
        for i, (p, m) in enumerate(self._server_trace(cfg)):
            eng.submit(p, max_new_tokens=m, request_id=f"r{i}")
        eng.run(deadline=600)
        return 1

    # ------------------------------------------------------------ fleet
    def _fleet_trace(self, cfg, groups=3, per_group=4, prefix=256):
        """Rounds of a multi-tenant trace: in each round one request of
        each group (its own ``prefix``-token system prompt and a unique
        16-96-token tail), then a round of two cold requests; budgets
        16-32. Three groups over two replicas: round-robin alternates each
        group between them."""
        import numpy as np
        rng = np.random.default_rng(12)
        V = cfg.vocab_size
        shared = [rng.integers(0, V, (prefix,)) for _ in range(groups)]
        rounds = [[(np.concatenate([sp, rng.integers(0, V, (int(t),))]),
                    int(m)) for sp, t, m in zip(
                        shared, rng.integers(16, 97, groups),
                        rng.integers(16, 33, groups))]
                  for _ in range(per_group)]
        rounds.append([(rng.integers(0, V, (int(n),)), int(m)) for n, m in
                       zip(rng.integers(64, 200, 2), rng.integers(16, 33, 2))])
        return rounds

    def phase_fleet(self):
        """Two replicas on one card (see the module doc)."""
        torch = self.torch
        import os
        import tempfile
        from paddle_tpu_torch.distributed.ft.chaos import ChaosPlan
        from paddle_tpu_torch.serving import (RequestState, ResiliencePolicy,
                                              ServingEngine, ServingFleet)
        cfg, params = self._model()
        sessions = [self._session(params, cfg, paged=False)
                    for _ in range(3)]
        paged = self._session(params, cfg, paged=True)

        def engine(sess, promote=2, resil=None):
            eng = ServingEngine(sess, max_queue=64, device=self.dev,
                                prefix_promote_after=promote,
                                resilience=resil, **FLEET_ENGINE)
            eng.prewarm()
            return eng

        def drain(engines):
            while any(e.pending for e in engines):
                for e in engines:
                    e.poll()

        # affinity against round-robin, round by round
        rounds = self._fleet_trace(cfg)
        fleet = ServingFleet([("r0", engine(sessions[0])),
                              ("r1", engine(sessions[1]))])
        for k, wave in enumerate(rounds):
            for i, (p, m) in enumerate(wave):
                fleet.submit(p, max_new_tokens=m, request_id=f"a{k}.{i}")
            fleet.run(deadline=600)
        aff = fleet.metrics()
        fleet.close()
        engines = [engine(sessions[0]), engine(sessions[1])]
        n = 0
        for k, wave in enumerate(rounds):
            for i, (p, m) in enumerate(wave):
                engines[n % 2].submit(p, max_new_tokens=m,
                                      request_id=f"b{k}.{i}")
                n += 1
            drain(engines)
        rr_hits = sum(r.prefix_hit_tokens for e in engines
                      for r in e.requests)
        for e in engines:
            e.close()
        line = dict(run="affinity_vs_round_robin", replicas=2,
                    requests=n, affinity_hit_tokens=aff[
                        "prefix_hit_tokens_total"],
                    affinity_routed=aff["affinity_routed_total"],
                    round_robin_hit_tokens=rr_hits)
        log("[fleet] " + json.dumps(line))
        if not line["affinity_hit_tokens"] > rr_hits:
            raise AssertionError(f"fleet affinity hit no more than "
                                 f"round-robin: {line}")

        # prefill/decode disaggregation against a monolithic engine
        trace = self._server_trace(cfg)
        prompts = [p for p, _ in trace]

        def serve(submit, run, metrics):
            for sess in sessions + [paged]:
                sess.reset_metrics()
            self._zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [submit(p, max_new_tokens=m, request_id=f"d{i}")
                    for i, (p, m) in enumerate(trace)]
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            met = metrics()
            return reqs, wall, met

        mono = engine(sessions[2])
        reqs, wall, met = serve(mono.submit,
                                lambda: mono.run(deadline=600), mono.metrics)
        want = [list(r.output) for r in reqs]
        toks = sum(len(o) for o in want)
        mono_line = dict(tokens_per_s=round(toks / wall, 1),
                         ttft_ms_p50=met["ttft_ms_p50"],
                         ttft_ms_p99=met["ttft_ms_p99"])
        self._read_counts("fleet monolithic", ("decode_attention",))
        mono.close()
        fleet = ServingFleet([("pf", engine(paged, promote=1), "prefill"),
                              ("d0", engine(sessions[0]), "decode")])
        hand = dict(ms=[], bytes=0)
        export, apply = fleet._export_handoff, fleet._apply_handoff

        def timed_export(rep, req, budget):
            out = export(rep, req, budget)
            if out is not None:
                hand["bytes"] += sum(
                    t.numel() * t.element_size()
                    for kv in (out.k, out.v)
                    for t in (kv if isinstance(kv, tuple) else (kv,)))
                if not all(isinstance(t, torch.Tensor)
                           and t.device.type == self.dev.type
                           for kv in (out.k, out.v)
                           for t in (kv if isinstance(kv, tuple) else (kv,))):
                    raise AssertionError("a handoff shipped no device tensor")
            return out

        def timed_apply(src, req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = apply(src, req)
            torch.cuda.synchronize()
            hand["ms"].append((time.perf_counter() - t0) * 1e3)
            return ok

        fleet._export_handoff, fleet._apply_handoff = timed_export, timed_apply
        reqs, wall, met = serve(fleet.submit,
                                lambda: fleet.run(deadline=600),
                                fleet.metrics)
        outs = fleet.outputs()
        got = [outs[f"d{i}"] for i in range(len(trace))]
        self._read_counts("fleet disaggregated", ("decode_attention_paged",
                                                  "decode_attention"))
        line = dict(run="disaggregated", replicas="prefill (paged) + decode",
                    requests=len(trace),
                    tokens_per_s=round(sum(len(o) for o in got) / wall, 1),
                    ttft_ms_p50=met["merged"]["ttft_ms_p50"],
                    ttft_ms_p99=met["merged"]["ttft_ms_p99"],
                    handoffs=met["handoffs_total"],
                    handoff_bytes=hand["bytes"],
                    handoff_ms_mean=round(sum(hand["ms"]) / max(1, len(
                        hand["ms"])), 3),
                    handoff_ms_max=round(max(hand["ms"], default=0.0), 3),
                    monolithic=mono_line)
        fleet.close()
        line["streams"] = self._streams_check(
            "fleet disaggregated", params, cfg, prompts, want, got)
        log("[fleet] " + json.dumps(line))
        if met["handoffs_total"] != len(trace):
            raise AssertionError(f"{met['handoffs_total']} handoffs for "
                                 f"{len(trace)} requests")

        # a replica killed mid-trace, recovered from its journal
        with tempfile.TemporaryDirectory() as tmp:
            pol = lambda name: ResiliencePolicy(
                chaos=ChaosPlan(), journal_path=os.path.join(tmp, name))
            fleet = ServingFleet([("k0", engine(sessions[0],
                                                resil=pol("k0.jsonl"))),
                                  ("k1", engine(sessions[1],
                                                resil=pol("k1.jsonl")))])
            for i, (p, m) in enumerate(trace):
                fleet.submit(p, max_new_tokens=m, request_id=f"d{i}")
            for _ in range(FLEET_KILL_AFTER_POLLS):
                fleet.poll()
            victim = max(fleet.replicas, key=lambda r: r.engine.pending)
            t0 = time.perf_counter()
            resumed = fleet.kill_replica(victim.name)
            failover_ms = (time.perf_counter() - t0) * 1e3
            fleet.run(deadline=600)
            outs = fleet.outputs()
            states = [r.state for r in fleet.requests]
            fleet.close()
        lost = sum(1 for s in states if s is not RequestState.DONE)
        got = [outs[f"d{i}"] for i in range(len(trace))]
        line = dict(run="kill_replica", victim=victim.name,
                    after_polls=FLEET_KILL_AFTER_POLLS,
                    resumed=len(resumed),
                    resumed_with_tokens=sum(1 for r in resumed
                                            if r.resumed_len),
                    failover_ms=round(failover_ms, 3), lost=lost)
        line["streams"] = self._streams_check(
            "fleet kill_replica", params, cfg, prompts, want, got)
        log("[fleet] " + json.dumps(line))
        if lost or not resumed:
            raise AssertionError(f"fleet failover: {line}")

    # ---------------------------------------------------------------- moe
    def _moe_model(self):
        """gpt3_1p3b with 8 experts, top-2, capacity factor 2.0 (the
        repo's MoE example), bf16, on the reference's init_params draw
        (seed 0): 6.95 B params."""
        from paddle_tpu_torch.models import gpt
        cfg = gpt.gpt3_1p3b(moe_experts=8, moe_top_k=2,
                            moe_capacity_factor=2.0)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = gpt.init_params(cfg, seed=0, device=self.dev)
        self.torch.cuda.synchronize()
        n = sum(t.numel() for t in params["blocks"].values()) \
            + params["wte"].numel() + params["wpe"].numel()
        log(f"[moe] gpt3_1p3b(moe_experts=8, moe_top_k=2, "
            f"moe_capacity_factor=2.0): {n / 1e9:.3f} B params bf16, "
            f"init_params (seed 0) in {time.perf_counter() - t0:.1f} s")
        return cfg, params

    def _moe_train(self, cfg, params, tokens, labels, n_timed=3):
        """A warm-up step, then ``n_timed`` timed with the counters zeroed
        just before and read just after (flash forward twice a layer under
        remat, each backward kernel once; bf16 moments take the plain
        AdamW, so no fused launch); the aux term; the eval step."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from paddle_tpu_torch.models import gpt
        tcfg = dataclasses.replace(cfg, remat=True, xent_chunks=4,
                                   opt_dtype=torch.bfloat16)
        opt = gpt.adamw_init(params, dtype=tcfg.opt_dtype, device=self.dev)
        step = gpt.build_train_step(tcfg, device=self.dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, labels)
        losses = [float(loss)]
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        self._zero_counts()
        times = []
        for _ in range(n_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, tokens, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated()
        counts = self._read_counts("moe train", (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv"))
        L = tcfg.n_layers
        self._expect_counts("moe train", counts, {
            "flash_attention_fwd": 2 * L * n_timed,
            "flash_attention_bwd_dq": L * n_timed,
            "flash_attention_bwd_dkv": L * n_timed})
        with torch.no_grad():
            _, aux = gpt._stage_fn(params, gpt._embed(params, tokens), tcfg)
        eval_loss = float(gpt.build_eval_step(tcfg, device=self.dev)(
            params, tokens, labels))
        B, S = tokens.shape
        step_s = sum(times) / len(times)
        C = gpt.moe_mod.capacity(tcfg.moe_capacity_factor, B * S,
                                 tcfg.moe_top_k, tcfg.moe_experts)
        log("[moe] " + json.dumps(dict(
            path="train", config="remat=True, xent_chunks=4, opt_dtype="
            "bf16, moe_dispatch=alltoall", batch=B, seq=S,
            capacity_per_expert=C, bucket_rows_per_layer=C * tcfg.moe_experts,
            warmup_step_s=round(warm_s, 3),
            step_ms=[round(t * 1e3, 3) for t in times],
            step_ms_mean=round(step_s * 1e3, 3),
            tokens_per_s=round(B * S / step_s, 1), losses=losses,
            aux_balance_loss=float(aux),
            aux_term=float(aux) * tcfg.moe_aux_weight, eval_loss=eval_loss,
            max_memory_allocated_gib=round(peak / 2 ** 30, 3))))
        if not all(np.isfinite(losses + [eval_loss, float(aux)])):
            raise AssertionError(f"moe train losses bad: {losses}, eval "
                                 f"{eval_loss}, aux {float(aux)}")
        del opt, step
        torch.cuda.empty_cache()
        return params

    def _profiled_ms(self, fn, iters):
        """Device ms of one call of ``fn`` (profiler, kernels summed over
        ``iters`` calls after one warm call) and the 4 kernels that take
        the most of it."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms, top = _device_rows(torch, prof, 4)
        return ms / iters, [dict(name=k[:60], ms=round(t / iters, 4),
                                 calls=c // iters) for k, t, c in top]

    def _by_op(self, fn, iters):
        """``fn`` run eagerly (:func:`eager_ticks`) under torch.profiler
        with host and device activity, after one warm call: the device ms
        and kernel launches of one call, and its 8 operators with the most
        device time (each operator's own kernels, summed over its calls),
        with their kernels a call."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch.inference import eager_ticks
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0))
        with eager_ticks():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        rows = prof.key_averages()
        kernels = [e for e in rows if getattr(e, "device_type", None) == cuda
                   and dev_us(e) > 0]
        ops = sorted((e for e in rows
                      if getattr(e, "device_type", None) != cuda
                      and not e.key.startswith("cuda") and dev_us(e) > 0),
                     key=dev_us, reverse=True)
        return dict(
            device_ms=round(sum(dev_us(e) for e in kernels) / 1e3 / iters, 4),
            kernels=sum(e.count for e in kernels) // iters,
            ops=[dict(op=e.key[:40], ms=round(dev_us(e) / 1e3 / iters, 4),
                      calls=e.count // iters) for e in ops[:8]])

    def _gate_ms(self, cfg, rows):
        """The serving gate of all L layers at ``rows`` tokens a layer,
        measured alone: ``softmax_f32`` (XLA's exp, bit for bit) and the
        top-k of the f32 gate logits [rows, E], as ``_moe_infer_ffn``
        runs them: device ms and kernel launches a tick (profiler)."""
        torch = self.torch
        from paddle_tpu_torch.parallel import moe as moe_mod
        logits = torch.randn(cfg.n_layers, rows, cfg.moe_experts,
                             device=self.dev)

        def gate():
            for li in range(cfg.n_layers):
                moe_mod.top_k_first(moe_mod.softmax_f32(logits[li]),
                                    cfg.moe_top_k)
        got = self._by_op(gate, 2)
        return dict(device_ms=got["device_ms"], kernels=got["kernels"])

    def _tick_device_ms(self, tag, params, cfg, by_op=False):
        """Device time (profiler, kernels summed) of one decode tick at 8
        rows and one W=128 chunk tick over 8 rows (each row's first
        chunk, not finalized), graphed, on a session of 8 slots x 512
        positions with 256-token prompts, and each tick's top kernels;
        ``by_op``: also each tick run eagerly, its device time grouped by
        operator (:meth:`_by_op`)."""
        import numpy as np
        sess = self._session(params, cfg, paged=False)
        prompt = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                                   (8, 256))
        slots = sess.admit(prompt)
        sess.step()             # the warm-up tick; the next captures
        decode, dtop = self._profiled_ms(lambda: sess.step(), 10)
        dops = self._by_op(lambda: sess.step(), 1) if by_op else None
        for s in slots:
            sess.evict(s)
        rows = [sess.alloc_slot(need_tokens=384) for _ in range(8)]
        chunks = [(r, prompt[i, :128], 0, False) for i, r in enumerate(rows)]
        sess.prefill_chunks(chunks, 128)
        chunk, ctop = self._profiled_ms(
            lambda: sess.prefill_chunks(chunks, 128), 5)
        cops = (self._by_op(lambda: sess.prefill_chunks(chunks, 128), 1)
                if by_op else None)
        for r in rows:
            sess.evict(r)
        del sess
        self.torch.cuda.empty_cache()
        out = dict(model=tag, decode_tick_device_ms=round(decode, 4),
                   chunk_tick_w128_device_ms=round(chunk, 4),
                   decode_top=dtop, chunk_top=ctop)
        if by_op:
            out.update(decode_eager_by_op=dops, chunk_eager_by_op=cops)
        return out

    def phase_moe(self):
        """MoE at full gpt3_1p3b width on one card: training, bf16 serving
        (graphed generate() against its eager twin, the 12-request paged
        replay), w8kv8 serving, and tick device times against the dense
        model's."""
        torch = self.torch
        import contextlib
        import numpy as np
        from paddle_tpu_torch.inference import eager_ticks
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        cfg, params = self._moe_model()
        L, E = cfg.n_layers, cfg.moe_experts
        tok = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                (4, 2049))
        tokens = torch.as_tensor(tok[:, :-1], device=self.dev)
        labels = torch.as_tensor(tok[:, 1:], device=self.dev)
        params = self._moe_train(cfg, params, tokens, labels)
        # bf16 serving: generate() graphed against eager_ticks(), counted
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (4, 256))
        N = 32
        gpt.generate(params, cfg, prompt[:2, :16], 3, device=self.dev)
        res = {}
        for name in ("eager", "graphed"):
            with (eager_ticks() if name == "eager"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                self._zero_counts()
                t0 = time.perf_counter()
                out = gpt.generate(params, cfg, prompt, N, device=self.dev)
                torch.cuda.synchronize()
                res[name] = (out, (time.perf_counter() - t0) * 1e3)
                counts = self._read_counts(f"moe generate {name}", (
                    "flash_attention_fwd", "decode_attention"))
                self._expect_counts(f"moe generate {name}", counts, {
                    "flash_attention_fwd": L,
                    "decode_attention": L * (N - 1)})
        same = torch.equal(res["eager"][0], res["graphed"][0])
        log("[moe] " + json.dumps(dict(
            path="generate bf16", batch=4, prompt=256, new_tokens=N,
            eager_ms=round(res["eager"][1], 3),
            graphed_ms=round(res["graphed"][1], 3),
            graphed_equals_eager=same)))
        if not same:
            raise AssertionError("moe generate: graphed output differs "
                                 "from eager")
        # the 12-request replay, paged, prefill_chunk=128
        sess = self._session(params, cfg, paged=True)
        _, line, counts = self._replay("moe paged chunk=128", sess,
                                       self._server_trace(cfg), 128)
        self._expect_tick_counts("moe paged chunk=128", counts, line, L,
                                 "decode_attention_paged")
        del sess
        torch.cuda.empty_cache()
        # device time of a decode tick and a W=128 chunk tick, MoE
        # against the dense model
        dense_cfg, dense = self._model()
        ticks = [self._tick_device_ms("moe bf16", params, cfg, by_op=True),
                 self._tick_device_ms("dense bf16", dense, dense_cfg,
                                      by_op=True)]
        # w8kv8: the experts' codes through quant_matmul, 2 E a layer
        qcfg = gpt.gpt3_1p3b(moe_experts=8, moe_top_k=2,
                             moe_capacity_factor=2.0, weight_quant="int8",
                             kv_cache_dtype="int8")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qp = quantize_gpt_params(params, qcfg, 8)
        torch.cuda.synchronize()
        from paddle_tpu_torch.quantization import quant_param_stats
        log("[moe] " + json.dumps(dict(
            path="quantize w8kv8", s=round(time.perf_counter() - t0, 3),
            **quant_param_stats(qp, qcfg))))
        del params
        torch.cuda.empty_cache()
        self._quant_generate("moe w8kv8", qcfg, qp, prompt)
        ticks.append(self._tick_device_ms("moe w8kv8", qp, qcfg))
        log("[moe] " + json.dumps(dict(
            path="tick device time", ticks=ticks,
            gate_decode=self._gate_ms(qcfg, 8),
            gate_chunk_w128=self._gate_ms(qcfg, 8 * 128))))
        del qp
        torch.cuda.empty_cache()

    def phase_moe_parity(self):
        """gpt3_1p3b(n_layers=2, f32, moe_experts=8) on the same numpy
        weights, the CPU (plain versions) against the card (kernels): 3
        training steps in each dispatch mode (losses within 1e-4), and
        prefill plus 4 decode steps in fp and w8kv8 (logits within 1e-3,
        identical greedy tokens)."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.quantization import quantize_gpt_params
        cfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32, moe_experts=8)
        marks = [("start", time.perf_counter())]
        weights = self._weights(cfg)
        marks.append(("weights", time.perf_counter()))
        tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 129))
        lines = []
        for mode in ("alltoall", "einsum"):
            tcfg = dataclasses.replace(cfg, moe_dispatch=mode, remat=True)
            sides = {}
            for dev in ("cpu", self.dev):
                # AdamW updates in place: a copy a mode
                params = {k: ({n: t.clone() for n, t in v.items()}
                              if isinstance(v, dict) else v.clone())
                          for k, v in weights[str(dev)].items()}
                opt = gpt.adamw_init(params, device=dev)
                step = gpt.build_train_step(tcfg, device=dev)
                losses = []
                for _ in range(3):
                    params, opt, loss = step(params, opt, tok[:, :-1],
                                             tok[:, 1:])
                    losses.append(float(loss))
                sides[str(dev)] = losses
                del params, opt
                marks.append((f"train {mode} {dev}", time.perf_counter()))
            err = max(abs(a - b) for a, b in zip(sides["cpu"],
                                                 sides[str(self.dev)]))
            lines.append(dict(path=f"train {mode}", batch=[2, 128],
                              losses_cpu=sides["cpu"],
                              losses_card=sides[str(self.dev)],
                              max_loss_err=err, tol=1e-4))
            log("[moe_parity] " + json.dumps(lines[-1]))
            if err > 1e-4:
                raise AssertionError(f"moe {mode} training: CPU and card "
                                     f"disagree by {err}")
        prompt = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                   (2, 100))
        for tag in ("f32", "w8kv8"):
            scfg, trees = cfg, weights
            if tag == "w8kv8":
                scfg = dataclasses.replace(cfg, weight_quant="int8",
                                           kv_cache_dtype="int8")
                trees = {d: quantize_gpt_params(t, scfg, 8)
                         for d, t in weights.items()}
                codes_equal = all(torch.equal(
                    trees["cpu"]["blocks"][n], trees[str(self.dev)]["blocks"][
                        n].cpu()) for n in ("w_in", "w_out", "w_in_s",
                                            "w_out_s"))
                if not codes_equal:
                    raise AssertionError("moe w8kv8: CPU and card codes "
                                         "differ")
            sides = [("cpu", trees["cpu"]),
                     (str(self.dev), trees[str(self.dev)])]
            if tag == "w8kv8":
                # printed beside the limit, on the CPU: the spread of a
                # forward on perturbed wpe, and two faults the limit must see
                g = torch.Generator().manual_seed(0)
                noisy = dict(trees["cpu"])
                noisy["wpe"] = noisy["wpe"] * (1 + MOE_QUANT_NOISE_REL
                                               * torch.randn(
                                                   noisy["wpe"].shape,
                                                   generator=g))
                sides.append(("noise", noisy))
                blocks = trees["cpu"]["blocks"]
                expert_leaves = [n for n in ("w_in", "w_in_s", "b_in",
                                             "w_out", "w_out_s", "b_out")
                                 if n in blocks]
                order = torch.arange(cfg.moe_experts)
                order[:2] = torch.tensor([1, 0])
                sides.append(("fault_swap", dict(trees["cpu"], blocks=dict(
                    blocks, **{n: blocks[n][:, order]
                               for n in expert_leaves}))))
                drop = {n: blocks[n].clone() for n in ("w_out_s", "b_out")}
                for t in drop.values():
                    t[:, 0] = 0
                sides.append(("fault_drop", dict(trees["cpu"], blocks=dict(
                    blocks, **drop))))
            logits = {}
            on_cpu = ("noise", "fault_swap", "fault_drop")
            for name, params in sides:
                dev = "cpu" if name in on_cpu else name
                kc, vc = gpt.init_kv_cache(scfg, 2, 128, device=dev)
                lg, kc, vc = gpt.prefill(params, scfg, torch.as_tensor(
                    prompt, device=dev), kc, vc)
                logits[name] = [lg.cpu()]
                logits[name + "_state"] = (kc, vc)
            toks = logits["cpu"][0].argmax(-1)
            for i in range(4):
                for name, params in sides:
                    if name.startswith("fault"):
                        continue        # a fault shows in the prefill
                    dev = "cpu" if name in on_cpu else name
                    kc, vc = logits[name + "_state"]
                    lg, _, _ = gpt.decode_one_token(
                        params, scfg, toks.to(dev), 100 + i, kc, vc)
                    logits[name].append(lg.cpu())
                toks = logits["cpu"][-1].argmax(-1)
            errs = [(c - g).abs().max().item() for c, g in
                    zip(logits["cpu"], logits[str(self.dev)])]
            tol, spread = 1e-3, {}
            if tag == "w8kv8":
                tol = MOE_QUANT_PARITY_TOL
                spread = {name: max((c - n).abs().max().item() for c, n in
                                    zip(logits["cpu"], logits[name]))
                          for name in on_cpu}
            agree = all(bool((c.argmax(-1) == g.argmax(-1)).all())
                        for c, g in zip(logits["cpu"],
                                        logits[str(self.dev)]))
            lines.append(dict(path=f"serve {tag}", prompt=[2, 100],
                              max_abs_err_prefill=errs[0],
                              max_abs_err_decode=max(errs[1:]), tol=tol,
                              cpu_spread=spread, greedy_tokens_equal=agree))
            log("[moe_parity] " + json.dumps(lines[-1]))
            if max(errs) > tol or not agree:
                raise AssertionError(f"moe {tag} serving: CPU and card "
                                     f"disagree: {errs}, tokens {agree}")
            marks.append((f"serve {tag}", time.perf_counter()))
            blind = [n for n in on_cpu[1:] if n in spread
                     and spread[n] <= tol]
            if blind:
                raise AssertionError(f"moe {tag} serving: the limit {tol} "
                                     f"does not see the faults {blind}")
        del weights
        torch.cuda.empty_cache()
        log("[moe_parity] seconds by part " + json.dumps({
            name: round(t - marks[i][1], 1)
            for i, (name, t) in enumerate(marks[1:])}))

    # -------------------------------------------------------------- guards
    GUARD_STEPS = 4       # the kill-resume trainer's steps
    GUARD_BATCH = (2, 1024)

    def _guard_cfg(self, n_layers=4):
        from paddle_tpu_torch.models import gpt
        return gpt.gpt3_1p3b(n_layers=n_layers, remat=True, fused_adamw=True,
                             xent_chunks=4)

    def _guard_data(self, cfg, t, B=4, S=2048):
        import numpy as np
        tok = np.random.default_rng(7000 + t).integers(0, cfg.vocab_size,
                                                       (B, S + 1))
        return (self.torch.as_tensor(tok[:, :-1], device=self.dev),
                self.torch.as_tensor(tok[:, 1:], device=self.dev))

    def _snapshot(self, params, opt):
        from paddle_tpu_torch.models import gpt
        return {k: v.clone() for k, v in
                gpt.train_state_arrays(params, opt).items()}

    def _untouched(self, params, opt, snap) -> list:
        """Names of the train-state tensors whose bits differ from
        ``snap``."""
        from paddle_tpu_torch.models import gpt
        torch = self.torch
        now = gpt.train_state_arrays(params, opt)
        bits = lambda t: t.reshape(-1).view(torch.uint8)
        return [k for k, v in now.items()
                if not torch.equal(bits(v), bits(snap[k]))]

    def _guards_sentinel(self):
        """Full-width dense gpt3_1p3b(remat, fused AdamW, xent_chunks=4):
        a healthy guarded step bitwise equal to the unguarded one from
        copies of the same state, the sentinel's cost, then the chaos
        plan's nan_grad and inf_grad (the corrupted value fed through the
        first positional-embedding element) and spike_loss (through
        loss_cap) steps: each gives its code and applies nothing."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.distributed.ft import ChaosPlan, chaos
        from paddle_tpu_torch.distributed.ft.sentinel import (
            H_APPLIED, H_CODE, H_GNORM, H_LOSS)
        from paddle_tpu_torch.models import gpt
        _, base = self._model()
        cfg = self._guard_cfg(base["blocks"]["w_in"].shape[0])
        tokens, labels = self._guard_data(cfg, 0)
        clone = lambda t: {k: ({n: x.clone() for n, x in v.items()}
                               if isinstance(v, dict) else v.clone())
                           for k, v in t.items()}
        pa, pb = clone(base), clone(base)
        oa, ob = (gpt.adamw_init(p, device=self.dev) for p in (pa, pb))
        step = gpt.build_train_step(cfg, device=self.dev)
        guarded = gpt.build_train_step(cfg, device=self.dev, sentinel=True)
        times = {"plain": [], "guarded": []}
        health = []
        self._zero_counts()
        for i in range(4):
            for name in ("plain", "guarded"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "plain":
                    pa, oa, loss = step(pa, oa, tokens, labels)
                    last = float(loss)
                else:
                    pb, ob, h = guarded(pb, ob, tokens, labels, float("inf"))
                    health.append(h.cpu().tolist())
                torch.cuda.synchronize()
                if i:           # the first step of each is the warm-up
                    times[name].append(time.perf_counter() - t0)
        counts = self._read_counts("guards healthy", ("fused_adamw",))
        bad = self._untouched(pb, ob, self._snapshot(pa, oa))
        ok = not bad and all(h[H_APPLIED] == 1.0 and h[H_CODE] == 0.0
                             for h in health) and health[-1][H_LOSS] == last
        plain_ms = 1e3 * sum(times["plain"]) / len(times["plain"])
        guard_ms = 1e3 * sum(times["guarded"]) / len(times["guarded"])
        log("[guards] " + json.dumps(dict(
            path="healthy guarded vs unguarded, 4 steps each",
            bitwise_equal=not bad, differing=bad[:4], health=health,
            step_ms_plain=[round(t * 1e3, 3) for t in times["plain"]],
            step_ms_guarded=[round(t * 1e3, 3) for t in times["guarded"]],
            sentinel_cost_ms=round(guard_ms - plain_ms, 3),
            sentinel_cost_share=round(guard_ms / plain_ms - 1, 4))))
        # 8 applied steps (4 each): remat runs each forward twice
        self._expect_counts("guards healthy", counts, {
            "flash_attention_fwd": 16 * cfg.n_layers,
            "flash_attention_bwd_dq": 8 * cfg.n_layers,
            "flash_attention_bwd_dkv": 8 * cfg.n_layers,
            "fused_adamw": 16 * 8})
        if not ok:
            raise AssertionError(f"guards: healthy guarded step differs: "
                                 f"{bad[:4]}, {health}")
        del pa, oa
        torch.cuda.empty_cache()
        plan = ChaosPlan.parse("nan_grad@step=1,inf_grad@step=2,"
                               "spike_loss@step=3:x40")
        want = {1: 3, 2: 3, 3: 4}
        self._zero_counts()
        for t in (1, 2, 3):
            snap = self._snapshot(pb, ob)
            probe = pb["wpe"][:1, :1].clone()
            x, _, kinds = chaos.corrupt_batch(plan, t, probe, labels)
            cap = float("inf")
            if "spike_loss" in kinds:
                cap = health[-1][H_LOSS] / 40.0
            pb["wpe"][:1, :1] = x
            poisoned = self._snapshot(pb, ob)
            pb, ob, h = guarded(pb, ob, tokens, labels, cap)
            h = h.cpu().tolist()
            bad = self._untouched(pb, ob, poisoned)
            pb["wpe"][:1, :1] = probe
            bad += self._untouched(pb, ob, snap)
            log("[guards] " + json.dumps(dict(
                path="anomalous step", step=t, faults=kinds, loss_cap=cap,
                health=h, params_and_moments_untouched=not bad)))
            if h[H_APPLIED] != 0.0 or int(h[H_CODE]) != want[t] or bad:
                raise AssertionError(f"guards step {t} ({kinds}): health "
                                     f"{h}, changed {bad[:4]}")
        counts = self._read_counts("guards anomalous", ())
        self._expect_counts("guards anomalous", counts, {
            "flash_attention_fwd": 6 * cfg.n_layers,
            "flash_attention_bwd_dq": 3 * cfg.n_layers,
            "flash_attention_bwd_dkv": 3 * cfg.n_layers})
        del pb, ob, base
        torch.cuda.empty_cache()

    def _guarded_run(self, cfg, n_steps, mask=(), plan=None, mgr=None,
                     guard=None):
        """run_guarded over gpt3_1p3b(n_layers=4) at full width from
        init_params seed 0, batches from the step index, nan_grad faults
        fed through the first positional-embedding element; with ``mgr``
        a save every 2 applied steps and restores from the last commit.
        Returns (losses, guard, save/restore timings)."""
        torch = self.torch
        from paddle_tpu_torch.distributed.ft import (ChaosPlan, StepGuard,
                                                     chaos, latest_step,
                                                     run_guarded)
        from paddle_tpu_torch.models import gpt
        plan = plan or ChaosPlan()
        guard = guard or StepGuard(name="chip")
        guard.quarantined.update(mask)
        params = gpt.init_params(cfg, seed=0, device=self.dev)
        opt = gpt.adamw_init(params, device=self.dev)
        guarded = gpt.build_train_step(cfg, device=self.dev, sentinel=True)
        timing = {"save_blocked_s": [], "restore_s": []}

        def data_for(t):
            tokens, labels = self._guard_data(cfg, t, *self.GUARD_BATCH)
            probe = torch.zeros((1, 1), dtype=cfg.dtype, device=self.dev)
            x, _, kinds = chaos.corrupt_batch(plan, t, probe, labels)
            return (tokens, x if kinds else None), labels

        def step_fn(state, x, y, cap):
            p, o = state
            tokens, poison = x
            if poison is None:
                p, o, h = guarded(p, o, tokens, y, cap)
                return (p, o), h
            keep = p["wpe"][:1, :1].clone()
            p["wpe"][:1, :1] = poison
            p, o, h = guarded(p, o, tokens, y, cap)
            p["wpe"][:1, :1] = keep     # nothing else moved: masked
            return (p, o), h

        saver = restorer = None
        if mgr is not None:
            def saver(nxt, state, g):
                t0 = time.perf_counter()
                mgr.save(nxt, gpt.train_state_arrays(*state),
                         {"train": {"next_step": int(nxt)},
                          "guard": g.state_dict()})
                timing["save_blocked_s"].append(time.perf_counter() - t0)

            def restorer(g):
                if latest_step(mgr.directory) is None:
                    return None
                t0 = time.perf_counter()
                arrays, aux, _ = mgr.restore()
                state = gpt.restore_train_state(arrays, cfg, device=self.dev)
                torch.cuda.synchronize()
                timing["restore_s"].append(time.perf_counter() - t0)
                return state, int(aux["train"]["next_step"])

        _, losses = run_guarded(step_fn, guard, (params, opt), data_for,
                                n_steps, save_every=2 if mgr else 0,
                                saver=saver, restorer=restorer)
        if mgr is not None:
            t0 = time.perf_counter()
            mgr.wait()
            timing["final_wait_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return losses, guard, timing

    def _guards_rollback(self, tmp):
        """run_guarded with a CheckpointManager under ``tmp``: a burst of
        two poisoned steps rolls back to the last commit, quarantines
        them, and the run ends on the trajectory of a clean run that
        skips them, bit for bit."""
        import os
        from paddle_tpu_torch.distributed.ft import (ChaosPlan,
                                                     CheckpointManager,
                                                     StepGuard)
        cfg = self._guard_cfg()
        mgr = CheckpointManager(os.path.join(tmp, "rollback"), keep=2,
                                name="chip")
        guard = StepGuard(max_consecutive=2, name="chip")
        la, ga, timing = self._guarded_run(
            cfg, 7, plan=ChaosPlan.parse("nan_grad@step=3-4"), mgr=mgr,
            guard=guard)
        lb, _, _ = self._guarded_run(cfg, 7, mask={3, 4})
        _, aux, _ = mgr.restore()
        st = mgr.stats
        line = dict(
            path="run_guarded rollback", config="gpt3_1p3b(n_layers=4)",
            batch=list(self.GUARD_BATCH), losses=la, clean_losses=lb,
            rollbacks=ga.rollbacks, quarantined=sorted(ga.quarantined),
            restored_step=ga.last_restored_step,
            aux_quarantine=aux["guard"]["quarantined"],
            bytes_per_commit=st["bytes_last"], commits=st["commits"],
            save_blocked_s=[round(t, 3) for t in timing["save_blocked_s"]],
            bg_write_ms_total=round(st["bg_write_ms_total"], 1),
            commit_ms_last=round(st["commit_ms_last"], 1),
            restore_s=[round(t, 3) for t in timing["restore_s"]])
        log("[guards] " + json.dumps(line))
        if ga.rollbacks != 1 or sorted(ga.quarantined) != [3, 4] or \
                ga.last_restored_step != 4 or \
                aux["guard"]["quarantined"] != [3, 4] or \
                sorted(la) != [0, 1, 2, 5, 6] or la != lb:
            raise AssertionError(f"guards rollback: {line}")

    def _guards_kill_resume(self, tmp):
        """A trainer child (this script, --guards-child) runs
        uninterrupted; a second, started beside it, is SIGKILLed after its
        first commit; a third resumes from that commit. The resumed
        losses equal the uninterrupted run's, bit for bit."""
        import os
        import signal
        from paddle_tpu_torch.distributed.ft import latest_step

        def child(mode, d):
            return [sys.executable, str(ROOT / "chip_smoke.py"),
                    "--guards-child", d, mode]

        def start(mode, d):
            # output to files: a pipe left unread while the parent watches
            # the other child could fill and stall this one
            out = open(os.path.join(tmp, f"{mode}.out"), "w+")
            err = open(os.path.join(tmp, f"{mode}.err"), "w+")
            return (mode, subprocess.Popen(child(mode, d), stdout=out,
                                           stderr=err, text=True),
                    out, err, time.perf_counter())

        def finish(started):
            mode, proc, out, err, t0 = started
            try:
                rc = proc.wait(timeout=600)
            finally:
                proc.kill()
                proc.wait()
            wall = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            stdout, stderr = out.read(), err.read()
            out.close()
            err.close()
            if rc != 0:
                raise AssertionError(f"guards {mode} child exited {rc}: "
                                     f"{stderr[-2000:]}")
            res = json.loads([ln for ln in stdout.splitlines()
                              if ln.startswith("{")][-1])
            res["wall_s"] = round(wall, 2)
            return res

        full_child = start("full", os.path.join(tmp, "full"))
        try:
            kill_dir = os.path.join(tmp, "killed")
            t0 = time.perf_counter()
            proc = subprocess.Popen(child("slow", kill_dir),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            try:
                while latest_step(kill_dir) is None:
                    if proc.poll() is not None:
                        raise AssertionError(
                            "guards: the trainer exited before a commit: "
                            + proc.stderr.read()[-2000:])
                    if time.perf_counter() - t0 > 600:
                        raise AssertionError("guards: no commit in 600 s")
                    time.sleep(0.05)
                proc.send_signal(signal.SIGKILL)
            finally:
                proc.wait()
                proc.stdout.close()
                proc.stderr.close()
            committed = latest_step(kill_dir)
            full = finish(full_child)
        finally:    # stopped on any failure above
            full_child[1].kill()
            full_child[1].wait()
        resumed = finish(start("resume", kill_dir))
        line = dict(path="kill and resume", config="gpt3_1p3b(n_layers=4)",
                    steps=self.GUARD_STEPS, batch=list(self.GUARD_BATCH),
                    killed_returncode=proc.returncode,
                    committed_at_kill=committed,
                    resumed_from=resumed["start_step"],
                    losses_full=full["losses"],
                    losses_resumed=resumed["losses"],
                    child_wall_s=dict(full=full["wall_s"],
                                      resume=resumed["wall_s"]),
                    restore_s=resumed["restore_s"])
        log("[guards] " + json.dumps(line))
        if proc.returncode != -signal.SIGKILL or committed is None or \
                resumed["start_step"] != committed or \
                resumed["losses"] != full["losses"][committed:]:
            raise AssertionError(f"guards kill/resume: {line}")

    def guards_child(self, d, mode):
        """The trainer of _guards_kill_resume (a process of its own):
        GUARD_STEPS steps of gpt3_1p3b(n_layers=4) from init_params seed
        0, a blocking-free save every 2 steps. ``slow`` sleeps 2 s a step
        so the parent can kill it mid-run; ``resume`` restores the newest
        commit first. Prints the losses as one JSON line."""
        torch = self.torch
        from paddle_tpu_torch.distributed.ft import (CheckpointManager,
                                                     latest_step)
        from paddle_tpu_torch.models import gpt
        cfg = self._guard_cfg()
        params = gpt.init_params(cfg, seed=0, device=self.dev)
        opt = gpt.adamw_init(params, device=self.dev)
        step = gpt.build_train_step(cfg, device=self.dev)
        mgr = CheckpointManager(d, keep=1, name="chip_child")
        start, restore_s = 0, None
        if mode == "resume" and latest_step(d) is not None:
            t0 = time.perf_counter()
            arrays, aux, s = mgr.restore()
            params, opt = gpt.restore_train_state(arrays, cfg, device=self.dev)
            torch.cuda.synchronize()
            restore_s = round(time.perf_counter() - t0, 3)
            start = int(aux["train"]["next_step"])
        losses = []
        for t in range(start, self.GUARD_STEPS):
            params, opt, loss = step(params, opt, *self._guard_data(
                cfg, t, *self.GUARD_BATCH))
            losses.append(float(loss))
            if (t + 1) % 2 == 0:
                mgr.save(t + 1, gpt.train_state_arrays(params, opt),
                         {"train": {"next_step": t + 1}})
            if mode == "slow":
                time.sleep(2.0)
        mgr.wait()
        print(json.dumps(dict(start_step=start, losses=losses,
                              restore_s=restore_s)), flush=True)
        return 0

    def phase_guards(self):
        """The training sentinel at full width, run_guarded with a
        checkpoint manager (rollback and quarantine), and a SIGKILLed
        trainer resumed on its uninterrupted trajectory."""
        import tempfile
        self._guards_sentinel()
        with tempfile.TemporaryDirectory() as tmp:
            self._guards_rollback(tmp)
            self._guards_kill_resume(tmp)

    # ------------------------------------------------------------ eager
    @staticmethod
    def _digits(rng, n):
        """Synthetic 1x28x28 digits: one fixed recipe a class (drawn from
        seed 0) plus noise; (images f32, labels int64)."""
        import numpy as np
        recipes = np.random.default_rng(0).standard_normal((10, 1, 28, 28))
        labels = rng.integers(0, 10, n)
        imgs = recipes[labels] + 0.5 * rng.standard_normal((n, 1, 28, 28))
        return imgs.astype(np.float32), labels.astype(np.int64)

    def _eager_lenet(self):
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models import LeNet
        torch = self.torch
        paddle.seed(0)
        model = LeNet()
        opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                    parameters=model.parameters())
        loss_fn = paddle.nn.CrossEntropyLoss()
        rng = np.random.default_rng(6)
        data = [self._digits(rng, 64) for _ in range(50)]
        losses, accs, marks = [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, y in data:
            marks.append(time.perf_counter())
            img, label = paddle.to_tensor(x), paddle.to_tensor(y)
            out = model(img)
            loss = loss_fn(out, label)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            accs.append(float((paddle.argmax(out, axis=1) == label)
                              .astype("float32").mean()))
        torch.cuda.synchronize()
        end = time.perf_counter()
        # the first step also pays the card's lazy set-up (cuDNN, cuBLAS)
        log("[eager] " + json.dumps(dict(
            model="LeNet", batch=64, steps=len(data),
            steps_per_s=round(len(data) / (end - t0), 2),
            steps_per_s_after_first=round((len(data) - 1)
                                          / (end - marks[1]), 2),
            first_step_ms=round((marks[1] - t0) * 1e3, 3),
            losses_first3=losses[:3], losses_last3=losses[-3:],
            train_accuracy_last3=round(float(np.mean(accs[-3:])), 4))))
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"LeNet loss did not fall: {losses}")

    def phase_eager(self):
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models import gpt
        paddle.set_device("gpu")
        self._eager_lenet()
        # the eager GPT at full width, f32, on the functional face's draw;
        # kept with a copy of its initial weights for the amp and jit phases
        t0 = time.perf_counter()
        self.gpt_f32 = None
        cfg, model, init, params = self._gpt_f32(keep_params=True)
        torch.cuda.synchronize()
        n = sum(p.size for p in model.parameters())
        log(f"[eager] GPT(gpt3_1p3b, f32): {n / 1e9:.3f} B params, built "
            f"and set from init_params in {time.perf_counter() - t0:.1f} s")
        tokens, labels = batch = self._gpt_batch(cfg)
        B, S = tokens.shape
        with torch.no_grad():
            got = model(tokens)._value
            want = gpt.forward(params, cfg, tokens._value)
            err = (got - want).abs().max().item()
        log("[eager] " + json.dumps(dict(
            eager_vs_functional_logits_max_abs_err=err, tol=1e-3,
            logits_shape=list(got.shape))))
        if not err <= 1e-3:
            raise AssertionError(f"eager and functional logits differ: {err}")
        del params, got, want
        torch.cuda.empty_cache()
        opt = paddle.optimizer.AdamW(learning_rate=3e-5,
                                     parameters=model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self._zero_counts()
        losses, times, _ = self._gpt_steps(model, opt, batch, 3)
        peak = torch.cuda.max_memory_allocated()
        names = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
        counts = self._read_counts("eager", names)
        self._expect_counts("eager", counts,
                            {n: 3 * cfg.n_layers for n in names})
        step_s = sum(times[1:]) / len(times[1:])
        self.eager_f32 = dict(
            losses=losses, step_ms=[round(t * 1e3, 3) for t in times],
            step_ms_mean_after_first=round(step_s * 1e3, 3),
            tokens_per_s=round(B * S / step_s, 1),
            max_memory_allocated_gib=round(peak / 2 ** 30, 3))
        log("[eager] " + json.dumps(dict(
            model="GPT(gpt3_1p3b, f32, dropout 0)", batch=B, seq=S,
            optimizer="AdamW(3e-5)", **self.eager_f32)))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"eager GPT losses bad: {losses}")
        del opt
        torch.cuda.empty_cache()

    def phase_eager_parity(self):
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models import LeNet, gpt
        cfg = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32)
        weights = self._weights(cfg)
        tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 257))
        x, y = self._digits(np.random.default_rng(9), 64)
        paddle.set_device("gpu")
        paddle.seed(0)
        lenet = {k: v.numpy() for k, v in LeNet().state_dict().items()}
        sides = {}
        for dev in ("cpu", "gpu"):
            # built on the card (the CPU's threefry draw of 206 M elements
            # would take minutes), moved, then set from the numpy weights
            paddle.set_device("gpu")
            model = gpt.GPT(cfg)
            net = LeNet()
            if dev == "cpu":
                model.to("cpu")
                net.to("cpu")
            paddle.set_device(dev)
            model.set_state_dict(gpt.eager_state_dict(
                weights["cpu" if dev == "cpu" else str(self.dev)]))
            net.set_state_dict(lenet)
            self._zero_counts()
            runs = {}
            for name, m, opt, batch in (
                    ("gpt", model, paddle.optimizer.AdamW(
                        3e-4, parameters=model.parameters()),
                     (tok[:, :-1], tok[:, 1:].reshape(-1))),
                    ("lenet", net, paddle.optimizer.Adam(
                        1e-3, parameters=net.parameters()), (x, y))):
                losses = []
                for _ in range(3):
                    out = m(paddle.to_tensor(batch[0]))
                    loss = paddle.nn.functional.cross_entropy(
                        paddle.reshape(out, [-1, out.shape[-1]]),
                        paddle.to_tensor(batch[1]))
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                    losses.append(float(loss))
                runs[name] = losses
            if dev == "gpu":
                names = ("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv")
                counts = self._read_counts("eager_parity", names)
                self._expect_counts("eager_parity", counts,
                                    {n: 3 * cfg.n_layers for n in names})
            # one Dropout(0.1) call's mask after seed()
            paddle.seed(11)
            drop = paddle.nn.Dropout(0.1)(paddle.ones([64, 2048]))
            runs["mask"] = (drop.numpy() != 0)
            sides[dev] = runs
            del model, net
        paddle.set_device("gpu")
        torch.cuda.empty_cache()
        cpu, card = sides["cpu"], sides["gpu"]
        errs = {k: max(abs(a - b) for a, b in zip(cpu[k], card[k]))
                for k in ("gpt", "lenet")}
        masks_equal = bool(np.array_equal(cpu["mask"], card["mask"]))
        log("[eager_parity] " + json.dumps(dict(
            config="GPT(gpt3_1p3b(n_layers=2, f32)) AdamW(3e-4) B=2 x "
                   "S=256; LeNet Adam(1e-3) B=64", steps=3,
            losses_cpu={k: cpu[k] for k in ("gpt", "lenet")},
            losses_card={k: card[k] for k in ("gpt", "lenet")},
            max_loss_err=errs, loss_tol=1e-4,
            dropout_mask_bitwise=masks_equal,
            dropout_kept_share=float(card["mask"].mean()))))
        if max(errs.values()) > 1e-4 or not masks_equal:
            raise AssertionError("eager CPU and card disagree")


    # ------------------------------------------------------------- amp
    def _gpt_f32(self, keep_params=False):
        """GPT(gpt3_1p3b) in f32 with init_params seed 0's weights, and a
        copy of those weights on the card to reset it from (the peak
        memory the phases read holds that copy); built once, by the eager
        phase or by the first of the amp and jit phases that runs. With
        ``keep_params`` the functional tree is returned too."""
        params = None
        if getattr(self, "gpt_f32", None) is None:
            torch = self.torch
            import paddle_tpu_torch as paddle
            from paddle_tpu_torch.models import gpt
            cfg = gpt.gpt3_1p3b(dtype=torch.float32)
            paddle.seed(0)
            model = gpt.GPT(cfg)
            params = gpt.init_params(cfg, seed=0, device=self.dev)
            init = {k: v.clone() for k, v in
                    gpt.eager_state_dict(params).items()}
            missing, unexpected = model.set_state_dict(init)
            if missing or unexpected:
                raise AssertionError(f"eager_state_dict keys: missing "
                                     f"{missing}, unexpected {unexpected}")
            if not keep_params:
                params = None
            self.gpt_f32 = (cfg, model, init)
        cfg, model, init = self.gpt_f32
        self._reset(model, init)
        if keep_params:
            return cfg, model, init, params
        return cfg, model, init

    @staticmethod
    def _reset(model, init):
        """The model back to f32 and to its initial weights."""
        model.to(dtype="float32")
        model.set_state_dict(init)

    def _gpt_batch(self, cfg):
        import numpy as np
        import paddle_tpu_torch as paddle
        # the eager phase's batch
        tok = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                (1, 2049))
        return (paddle.to_tensor(tok[:, :-1]),
                paddle.to_tensor(tok[:, 1:].reshape(-1)))

    def _gpt_steps(self, model, opt, batch, n, amp=None, scaler=None,
                   snapshot=None):
        """``n`` training steps; returns (losses, step seconds, per-step
        scaler records). ``amp``: auto_cast kwargs. With a scaler the
        step is the reference's: scale, backward, unscale_ (one host
        read), the optimizer step unless a gradient is not finite,
        update; ``snapshot(opt)``, taken before each step (outside its
        time), checks that a skipped step changed no parameter or moment
        from the step's start."""
        torch = self.torch
        import contextlib
        import paddle_tpu_torch as paddle
        tokens, labels = batch
        losses, times, records = [], [], []
        for _ in range(n):
            check = snapshot(opt) if snapshot else None
            t0 = time.perf_counter()
            ctx = (paddle.amp.auto_cast(**amp) if amp
                   else contextlib.nullcontext())
            with ctx:
                logits = model(tokens)
                loss = paddle.nn.functional.cross_entropy(
                    paddle.reshape(logits, [-1, logits.shape[-1]]), labels)
            if scaler is None:
                loss.backward()
                opt.step()
            else:
                scale = scaler.get_init_loss_scaling()
                scaler.scale(loss).backward()
                scaler.unscale_(opt)
                found = scaler._found_inf
                if not found:
                    opt.step()
                scaler.update()
                checked = bool(found and check)
                if checked:
                    check()
                records.append(dict(scale=scale, found_inf=found,
                                    checked=checked))
            opt.clear_grad()
            losses.append(float(loss))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del logits, loss, check
        return losses, times, records

    def _skip_check(self, model):
        """A snapshot function for _gpt_steps: copies every parameter and
        optimizer moment; the check it returns asserts them bitwise
        equal."""
        torch = self.torch

        def snap(opt):
            params = [p._value.detach().clone() for p in model.parameters()]
            states = {k: {n: v.clone() for n, v in st.items()
                          if isinstance(v, torch.Tensor)}
                      for k, st in opt._states.items()}

            def check():
                for p, b in zip(model.parameters(), params):
                    if not torch.equal(p._value, b):
                        raise AssertionError("a skipped step moved a "
                                             "parameter")
                if set(opt._states) != set(states):
                    raise AssertionError("a skipped step made moments")
                for k, st in states.items():
                    for n, v in st.items():
                        if not torch.equal(opt._states[k][n], v):
                            raise AssertionError(f"a skipped step moved "
                                                 f"moment {n}")
            return check
        return snap

    def _flash_counts(self, path, steps, n_layers, routes=("wgmma",)):
        """Exact flash launches of ``steps`` training steps: n_layers
        each a step, forward, dq and dk/dv, all on ``routes``."""
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        names = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
        counts = self._read_counts(path, names)
        self._expect_counts(path, counts,
                            {n: steps * n_layers for n in names})
        for fn in (fa.flash_attention, fa.flash_attention_bwd_dq,
                   fa.flash_attention_bwd_dkv):
            bad = {r: n for r, n in fn.routes.items()
                   if n and r not in routes}
            if bad:
                raise AssertionError(f"{path}: flash launches on {bad}")
        return counts

    def _amp_run(self, model, init, level, dtype, steps=3, white=(),
                 counts=None):
        """``steps`` AdamW(3e-5) steps of the f32 model from ``init``
        under auto_cast(level, dtype) (O2: decorate first, master weights
        on), custom white list ``white``; flash launches checked when
        ``counts`` names the path. Returns the run's line."""
        torch = self.torch
        import paddle_tpu_torch as paddle
        self._reset(model, init)
        opt = paddle.optimizer.AdamW(3e-5, parameters=model.parameters())
        if level == "O2":
            paddle.amp.decorate(model, opt, level="O2", dtype=dtype,
                                master_weight=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self._zero_counts()
        amp = (dict(level=level, dtype=dtype, custom_white_list=set(white))
               if level else None)
        losses, times, _ = self._gpt_steps(model, opt, self._gpt_batch(
            model.cfg), steps, amp)
        peak = torch.cuda.max_memory_allocated()
        if counts:
            self._flash_counts(counts, steps, model.cfg.n_layers)
        step_s = sum(times[1:]) / len(times[1:])
        del opt
        torch.cuda.empty_cache()
        return dict(losses=losses, step_ms=[round(t * 1e3, 3) for t in times],
                    step_ms_mean_after_first=round(step_s * 1e3, 3),
                    tokens_per_s=round(2048 / step_s, 1),
                    max_memory_allocated_gib=round(peak / 2 ** 30, 3))

    def phase_amp(self):
        torch = self.torch
        import contextlib
        import io
        import numpy as np
        import paddle_tpu_torch as paddle
        import paddle_tpu_torch.amp as pamp
        from paddle_tpu_torch import tensor as ptensor
        from paddle_tpu_torch.models import gpt
        paddle.set_device("gpu")
        t0 = time.perf_counter()
        cfg, model, init = self._gpt_f32()
        batch = self._gpt_batch(cfg)
        log(f"[amp] GPT(gpt3_1p3b) f32 from init_params seed 0 in "
            f"{time.perf_counter() - t0:.1f} s")
        # the f32 run is the eager phase's when it ran (the same model,
        # weights, batch and steps)
        f32 = getattr(self, "eager_f32", None)
        if f32 is None:
            f32 = self._amp_run(model, init, None, None)
            log("[amp] f32 " + json.dumps(f32))
        runs = {}
        for level in ("O1", "O2"):
            name = f"{level} bf16"
            runs[name] = self._amp_run(model, init, level, "bfloat16",
                                       counts=f"amp {name}")
            log(f"[amp] {name} " + json.dumps(runs[name]))
        # planted faults, each read against f32 beside its level's limit
        sound_cast = pamp._amp_cast

        def cast_without_grad(t, dtype):
            return ptensor.apply_op("amp_cast",
                                    lambda v: v.detach().to(dtype), t)
        for level in ("O1", "O2"):
            name, limit = f"{level} bf16", AMP_LOSS_VS_F32[level]
            sound = max(abs(a - b) for a, b in zip(runs[name]["losses"],
                                                   f32["losses"]))
            faults = {}
            for fault, white in AMP_FAULTS.items():
                if white is None:
                    pamp._amp_cast = cast_without_grad
                try:
                    got = self._amp_run(model, init, level, "bfloat16",
                                        white=white or ())["losses"]
                finally:
                    pamp._amp_cast = sound_cast
                faults[fault] = max(abs(a - b)
                                    for a, b in zip(got, f32["losses"]))
            seen = {k: v > limit for k, v in faults.items()}
            log("[amp] " + json.dumps(dict(
                run=name, loss_vs_f32_max_abs=sound, limit=limit,
                planted_faults_vs_f32_max_abs=faults,
                faults_outside_limit=seen)))
            if not all(np.isfinite(runs[name]["losses"])) or sound > limit:
                raise AssertionError(f"amp {name} losses {runs[name]} far "
                                     f"from f32 {f32['losses']}")
            blind = [k for k in AMP_MUST_SEE[level] if not seen[k]]
            if blind:
                raise AssertionError(f"amp {name}: the limit {limit} does "
                                     f"not see the faults {blind}")
        self.amp_o1 = runs["O1 bf16"]
        # float16 with the default GradScaler, then the same model and
        # moments under a scaler from 2^40, where every f16 gradient
        # overflows: each skipped step is checked bitwise
        self._reset(model, init)
        opt = paddle.optimizer.AdamW(3e-5, parameters=model.parameters())
        self._zero_counts()
        losses, times, records = self._gpt_steps(
            model, opt, batch, 6, dict(dtype="float16"),
            paddle.amp.GradScaler(), self._skip_check(model))
        self._flash_counts("amp O1 f16", 6, cfg.n_layers)
        f_losses, _, forced = self._gpt_steps(
            model, opt, batch, 2, dict(dtype="float16"),
            paddle.amp.GradScaler(init_loss_scaling=2.0 ** 40),
            self._skip_check(model))
        applied = sum(not r["found_inf"] for r in records)
        checked = sum(r["checked"] for r in records + forced)
        log("[amp] O1 f16 " + json.dumps(dict(
            losses=losses, scaler=records, applied_steps=applied,
            step_ms=[round(t * 1e3, 3) for t in times],
            forced_overflow=dict(losses=f_losses, scaler=forced),
            skipped_steps_checked_bitwise=checked)))
        if not all(np.isfinite(losses)) or applied == 0:
            raise AssertionError(f"amp f16 applied no step: {records}")
        if not all(r["found_inf"] for r in forced) or \
                checked != sum(r["found_inf"] for r in records + forced):
            raise AssertionError(f"amp f16 forced overflow: {forced}")
        del opt
        # the operator stats of one O1 step
        self._reset(model, init)
        opt = paddle.optimizer.AdamW(3e-5, parameters=model.parameters())
        with contextlib.redirect_stdout(io.StringIO()):
            paddle.amp.enable_operator_stats_collection()
            try:
                self._gpt_steps(model, opt, batch, 1,
                                dict(level="O1", dtype="bfloat16"))
            finally:
                stats = paddle.amp.disable_operator_stats_collection()
        by_dtype = {}
        for (op, dt), n in stats.items():
            by_dtype[dt] = by_dtype.get(dt, 0) + n
        log("[amp] operator stats, one O1 bf16 step: " + json.dumps(dict(
            calls_by_dtype=by_dtype,
            ops={f"{op}/{dt}": n for (op, dt), n in sorted(stats.items())})))
        if stats.get(("flash_attn_bhsd", "bfloat16")) != cfg.n_layers:
            raise AssertionError(f"operator stats: {stats}")
        del opt
        torch.cuda.empty_cache()
        # the f16 kernels against their plain versions, and bf16 at the
        # eager GPT's shape beside SDPA
        for dtype in (torch.float16, torch.bfloat16):
            self._flash_case(1, 16, 2048, 2048, 128, dtype, True, False,
                             time_it=True)
            self._flash_bwd_case(1, 16, 2048, 2048, 128, dtype, True,
                                 time_it=True)
        self._flash_bwd_case(2, 4, 130, 130, 64, torch.float16, True,
                             time_it=False)
        self._flash_case(2, 4, 200, 328, 32, torch.float16, True, True,
                         time_it=False)
        # the 2-layer cut under O1 bf16, the CPU against the card, and the
        # card with a black-list op planted in bf16
        cut = gpt.gpt3_1p3b(n_layers=2, dtype=torch.float32)
        weights = self._weights(cut)
        tok = np.random.default_rng(8).integers(0, cut.vocab_size, (2, 129))
        sides = [("cpu", "cpu", ()), ("card", "gpu", ())]
        sides += [(k, "gpu", w) for k, w in AMP_FAULTS.items() if w]
        loss = {}
        for name, dev, white in sides:
            paddle.set_device("gpu")
            m = gpt.GPT(cut)
            if dev == "cpu":
                m.to("cpu")
            paddle.set_device(dev)
            m.set_state_dict(gpt.eager_state_dict(
                weights["cpu" if dev == "cpu" else str(self.dev)]))
            with paddle.amp.auto_cast(dtype="bfloat16",
                                      custom_white_list=set(white)):
                logits = m(paddle.to_tensor(tok[:, :-1]))
                loss[name] = float(paddle.nn.functional.cross_entropy(
                    paddle.reshape(logits, [-1, cut.vocab_size]),
                    paddle.to_tensor(tok[:, 1:].reshape(-1))))
            del m, logits
        paddle.set_device("gpu")
        err = abs(loss["cpu"] - loss["card"])
        faults = {k: abs(loss["cpu"] - v) for k, v in loss.items()
                  if k not in ("cpu", "card")}
        log("[amp] " + json.dumps(dict(
            cut="GPT(gpt3_1p3b(n_layers=2)) f32 weights, O1 bf16, B=2 x "
                "S=128", loss_cpu=loss["cpu"], loss_card=loss["card"],
            abs_err=err, limit=AMP_CUT_LOSS_TOL,
            planted_faults_on_the_card_abs_err=faults)))
        if err > AMP_CUT_LOSS_TOL:
            raise AssertionError(f"O1 bf16 cut: CPU {loss['cpu']} card "
                                 f"{loss['card']}")
        blind = [k for k in AMP_MUST_SEE["cut"]
                 if faults[k] <= AMP_CUT_LOSS_TOL]
        if blind:
            raise AssertionError(f"O1 bf16 cut: the limit does not see "
                                 f"{blind}")
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- jit
    def _top_kernels(self, fn, iters=3):
        """Device ms of one call of ``fn`` under torch.profiler, and its
        five largest kernel rows (name, ms a call, launches a call)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, top = _device_rows(torch, prof, 5)
        return dict(device_ms_a_call=round(total / iters, 3),
                    top_kernels=[(k[:60], round(ms / iters, 3), c // iters)
                                 for k, ms, c in top])

    def _lenet_jit(self):
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models import LeNet
        rng = np.random.default_rng(16)
        data = [self._digits(rng, 64) for _ in range(40)]
        nets = []
        for _ in range(2):      # the same draw twice: net and its twin
            paddle.seed(0)
            nets.append(LeNet())
        net, twin = nets
        opts = [paddle.optimizer.Adam(1e-3, parameters=m.parameters())
                for m in (net, twin)]
        loss_fn = paddle.nn.CrossEntropyLoss()

        def step(m, opt, x, y):
            loss = loss_fn(m(paddle.to_tensor(x)), paddle.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss)
        for x, y in data[:20]:
            step(net, opts[0], x, y)
            step(twin, opts[1], x, y)
        paddle.jit.to_static(net)       # inductor, full graph
        static, eager, t0 = [], [], time.perf_counter()
        for x, y in data[20:]:
            static.append(step(net, opts[0], x, y))
        torch.cuda.synchronize()
        t_static = time.perf_counter() - t0
        for x, y in data[20:]:
            eager.append(step(twin, opts[1], x, y))
        if not all(np.isfinite(static)) or not static[-1] < static[0]:
            raise AssertionError(f"to_static LeNet did not train: {static}")
        sf = net._static_function
        err = max(abs(a - b) for a, b in zip(static, eager))
        log("[jit] " + json.dumps(dict(
            model="LeNet", eager_steps=20, static_steps=20,
            losses_static=static[-3:], losses_eager=eager[-3:],
            max_loss_err=err, limit=JIT_LENET_TOL, compiles=sf.compiles,
            compile_s=[round(t, 2) for t in sf.compile_seconds],
            static_wall_s=round(t_static, 3))))
        if err > JIT_LENET_TOL or sf.compiles != 1:
            raise AssertionError("to_static LeNet differs from eager")
        return net

    def _host_profile(self, fn, calls=5, n=6):
        """The ``n`` Python functions with the most own time over
        ``calls`` calls of ``fn`` (cProfile), as (function, ms a call)."""
        import cProfile
        import pstats
        fn()
        self.torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(calls):
            fn()
        self.torch.cuda.synchronize()
        prof.disable()
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
        return [(f"{Path(f).name}:{line}({name})", round(tt / calls * 1e3, 3))
                for (f, line, name), (_, _, tt, _, _) in top]

    def _serve(self, runs, want, n_layers):
        """Each served form of ``runs`` (name -> call returning logits on
        the card): its flash forward launches a call, ms a call (wall,
        CUDA events), the host's own time to enqueue one call, the
        logits' error relative to max|want|, its device time and largest
        kernels; fails unless a call launches ``n_layers`` flash forwards
        and the logits hold within JIT_EXPORT_TOL."""
        torch = self.torch
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        res = {}
        for name, run in runs.items():
            self._zero_counts()
            got = run()
            torch.cuda.synchronize()
            n = fa.flash_attention.launches
            ms = self.time_ms(run, iters=10, warmup=2)
            host = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            err = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            res[name] = dict(flash_fwd_launches_a_call=n,
                             ms_a_call=round(ms, 3),
                             host_enqueue_ms_median=round(
                                 sorted(host)[2], 3),
                             logits_rel_err=err, **self._top_kernels(run))
            if n != n_layers or err > JIT_EXPORT_TOL:
                raise AssertionError(f"{name}: {res[name]}")
        return res

    def phase_jit(self):
        torch = self.torch
        import numpy as np
        import os
        import shutil
        import tempfile
        import paddle_tpu_torch as paddle
        paddle.set_device("gpu")
        lenet = self._lenet_jit()
        cfg, model, init = self._gpt_f32()
        batch = self._gpt_batch(cfg)
        tokens = batch[0]
        tmp = tempfile.mkdtemp(prefix="jit_save_")
        try:
            # the O2 bf16 model exported and served, before and after the
            # GPT's compile below (one process: the compile slows the
            # host's dispatch of every later call)
            paddle.amp.decorate(model, level="O2", dtype="bfloat16")
            model.eval()
            path = os.path.join(tmp, "gpt")
            t0 = time.perf_counter()
            paddle.jit.save(model, path, input_spec=[
                paddle.jit.InputSpec([1, 2048], "int64")])
            save_s = time.perf_counter() - t0
            with paddle.no_grad():
                want = model(tokens)._value
            loaded = paddle.jit.load(path)
            pred = paddle.inference.create_predictor(
                paddle.inference.Config(path))
            tok_np = tokens.numpy()
            handle = pred.get_input_handle(pred.get_input_names()[0])

            def handles():      # outputs stay on the card
                handle.copy_from_cpu(tok_np)
                pred.run()
                return pred._outputs[0]

            def eager():
                with paddle.no_grad():
                    return model(tokens)._value
            runs = {"jit.load": lambda: loaded(tokens)._value,
                    "predictor": handles, "eager layer": eager}
            res = self._serve(runs, want, cfg.n_layers)
            res["jit.load"]["host_profile"] = self._host_profile(
                runs["jit.load"])
            # the list form returns the logits on the host, as the
            # reference's does (206 MB of bf16 a call)
            res["predictor"]["list_form_ms_a_call_with_host_copy"] = round(
                self.time_ms(lambda: pred.run([tok_np]), iters=3, warmup=1),
                3)
            line = dict(model="GPT(gpt3_1p3b) O2 bf16, eval", input=[1, 2048],
                        save_s=round(save_s, 2), limit=JIT_EXPORT_TOL,
                        pdmodel_bytes=os.path.getsize(path + ".pdmodel"),
                        pdparams_bytes=os.path.getsize(path + ".pdparams"),
                        **res)
            log("[jit] " + json.dumps(line))
            # to_static of the f32 model under O1 bf16
            model.train()
            self._reset(model, init)
            self._jit_gpt(cfg, model, batch)
            # the exported forms again, after the compile
            del runs["eager layer"]
            res = self._serve(runs, want, cfg.n_layers)
            res["jit.load"]["host_profile"] = self._host_profile(
                runs["jit.load"])
            import threading
            log("[jit] served after the GPT's compile " + json.dumps(dict(
                res, threads=[t.name for t in threading.enumerate()])))
            del loaded, pred, want, runs
            # LeNet exported and served
            lenet.eval()
            paddle.jit.save(lenet, os.path.join(tmp, "lenet"),
                            input_spec=[paddle.jit.InputSpec(
                                [64, 1, 28, 28], "float32")])
            x, _ = self._digits(np.random.default_rng(17), 64)
            out = paddle.inference.create_predictor(paddle.inference.Config(
                os.path.join(tmp, "lenet"))).run([x])[0]
            with paddle.no_grad():
                want = type(lenet).forward(lenet, paddle.to_tensor(x)).numpy()
            err = float(np.abs(out - want).max())
            log("[jit] " + json.dumps(dict(model="LeNet predictor",
                                           max_abs_err=err, limit=1e-5)))
            if err > 1e-5:
                raise AssertionError(f"LeNet predictor differs: {err}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.gpt_f32 = None
        del model, init
        torch.cuda.empty_cache()

    def _jit_gpt(self, cfg, model, batch):
        """to_static(GPT) under O1 bf16 for 3 AdamW steps against the amp
        phase's eager O1 losses (run here when the amp phase did not):
        one compile, exact flash launches, its seconds by torch's timers;
        the model is back to eager after."""
        torch = self.torch
        import paddle_tpu_torch as paddle
        from torch._dynamo.utils import compilation_time_metrics
        from torch._inductor import config as inductor_config
        amp = dict(level="O1", dtype="bfloat16")
        base = getattr(self, "amp_o1", None)
        if base is None:        # the amp phase did not run: its O1 twin
            opt = paddle.optimizer.AdamW(3e-5, parameters=model.parameters())
            losses, times, _ = self._gpt_steps(model, opt, batch, 3, amp)
            base = dict(losses=losses, step_ms_mean_after_first=round(
                sum(times[1:]) / 2 * 1e3, 3))
            del opt
            self._reset(model, self.gpt_f32[2])
        compilation_time_metrics.clear()
        paddle.jit.to_static(model)
        opt = paddle.optimizer.AdamW(3e-5, parameters=model.parameters())
        self._zero_counts()
        losses, times, _ = self._gpt_steps(model, opt, batch, 3, amp)
        self._flash_counts("jit to_static O1 bf16", 3, cfg.n_layers)
        sf = model._static_function
        object.__delattr__(model, "forward")       # back to eager
        del opt
        # where the compile's seconds went (torch's own timers; nested
        # timers repeat their children's time)
        parts = sorted(((k, round(sum(v), 2)) for k, v in
                        compilation_time_metrics.items()),
                       key=lambda kv: -kv[1])[:16]
        log("[jit] GPT compile seconds by timer " + json.dumps(dict(
            parts, compile_threads=inductor_config.compile_threads)))
        step_s = sum(times[1:]) / 2
        errs = [abs(a - b) for a, b in zip(losses, base["losses"])]
        line = dict(model="to_static(GPT(gpt3_1p3b)), O1 bf16, inductor, "
                          "fullgraph", losses=losses,
                    eager_losses=base["losses"], max_loss_err=max(errs),
                    limit=JIT_GPT_TOL, compiles=sf.compiles,
                    compile_s=[round(t, 2) for t in sf.compile_seconds],
                    step_ms=[round(t * 1e3, 3) for t in times],
                    step_ms_mean_after_first=round(step_s * 1e3, 3),
                    eager_step_ms=base["step_ms_mean_after_first"],
                    tokens_per_s=round(2048 / step_s, 1))
        log("[jit] " + json.dumps(line))
        if sf.compiles != 1 or max(errs) > JIT_GPT_TOL:
            raise AssertionError(f"to_static GPT: {line}")

    # ------------------------------------------------------------ hapi
    def phase_hapi(self):
        import shutil
        import tempfile
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models import LeNet
        from paddle_tpu_torch.vision.datasets import MNIST
        paddle.set_device("gpu")
        tmp = tempfile.mkdtemp(prefix="hapi_")
        res = {}
        try:
            for workers, epochs in ((0, 1), (2, 2)):
                paddle.seed(0)
                model = paddle.Model(LeNet())
                model.prepare(paddle.optimizer.Adam(
                    1e-3, parameters=model.parameters()),
                    paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
                train = MNIST(mode="train")
                steps = epochs * len(train) // 64
                cbs = [paddle.callbacks.EarlyStopping(monitor="loss",
                                                      patience=2),
                       paddle.callbacks.ModelCheckpoint(save_dir=tmp)]
                t0 = time.perf_counter()
                model.fit(train, batch_size=64, epochs=epochs,
                          num_workers=workers, callbacks=cbs, verbose=0,
                          drop_last=True)
                self.torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ev = model.evaluate(MNIST(mode="test"), batch_size=64,
                                    verbose=0)
                res[f"workers_{workers}"] = dict(
                    epochs=epochs, steps=steps,
                    steps_per_s=round(steps / wall, 2), eval=ev)
            import os
            saved = sorted(os.listdir(tmp))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log("[hapi] " + json.dumps(dict(
            model="paddle.Model(LeNet()) Adam(1e-3) on MNIST(train), "
                  "batch 64", checkpoints=saved, limit_acc=HAPI_MIN_ACC,
            **{k: {**v, "eval": {m: float(x) for m, x in v["eval"].items()}}
               for k, v in res.items()})))
        acc = float(res["workers_2"]["eval"]["acc"])
        if acc < HAPI_MIN_ACC or "1.pdparams" not in saved:
            raise AssertionError(f"hapi: eval accuracy {acc}, saved {saved}")


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
    # the resil phase's crash victim, run as a process of its own
    ap.add_argument("--resil-child", default=None, help=argparse.SUPPRESS)
    # the guards phase's trainer (DIR MODE), run as a process of its own
    ap.add_argument("--guards-child", nargs=2, default=None,
                    help=argparse.SUPPRESS)
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
    if args.resil_child:
        return Smoke(torch).resil_child(args.resil_child)
    if args.guards_child:
        return Smoke(torch).guards_child(*args.guards_child)
    card = gpu_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]} | "
        f"{os.cpu_count()} CPUs, torch threads {torch.get_num_threads()}")
    smoke = Smoke(torch)
    t_all = time.perf_counter()
    for p in phases:
        t0 = time.perf_counter()
        getattr(smoke, f"phase_{p}")()
        # what the phase left on the card (a later phase's times read it)
        mem = torch.cuda.memory_stats() if p != "build" else {}
        gib = {k: mem.get(f"{k}_bytes.all.current", 0) / 2 ** 30
               for k in ("allocated", "reserved")}
        log(f"[{p}] passed in {time.perf_counter() - t0:.1f} s; card "
            f"memory left allocated {gib['allocated']:.2f} GiB, reserved "
            f"{gib['reserved']:.2f} GiB, allocator retries "
            f"{mem.get('num_alloc_retries', 0)}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    csrc, pallas = "paddle_tpu_torch/csrc/", "paddle_tpu/ops/pallas/"
    triton_src = "paddle_tpu_torch/ops/kernels/primitives_triton.py"
    for name, src, rep in (
            ("flash_attention_fwd", "flash_attention_fwd.cu",
             "flash_attention.py:55"),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "flash_attention.py:158"),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "flash_attention.py:196"),
            ("decode_attention", "decode_attention.cu",
             "decode_attention.py:217"),
            ("fused_adamw", "fused_adamw.cu", "fused_adamw.py:34"),
            ("quant_matmul", "quant_matmul.cu", "quant_matmul.py:65"),
            ("decode_attention_q8", "decode_attention.cu",
             "decode_attention.py:266"),
            ("decode_attention_paged", "decode_attention.cu",
             "decode_attention.py:362"),
            ("decode_attention_paged_q8", "decode_attention.cu",
             "decode_attention.py:371"),
            ("fused_residual_ln", "fused_residual_ln.cu",
             "fused_residual_ln.py:60"),
            ("elementwise_kernel", triton_src, "primitives.py:101"),
            ("reduce_kernel", triton_src, "primitives.py:134")):
        row = dict(smoke.rows.get(name, {}))
        route = "triton" if src == triton_src else "cuda"
        row.update(name=name, route=route,
                   source=src if route == "triton" else csrc + src,
                   replaces=pallas + rep)
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

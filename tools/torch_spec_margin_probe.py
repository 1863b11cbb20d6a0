#!/usr/bin/env python3
"""How far a faulty verify window moves the readings of ``chip_smoke.py``'s
spec margin rule, on one NVIDIA card.

    python3 tools/torch_spec_margin_probe.py [--shifts 0,1,64]

For each shift, the rule's run at full ``gpt3_1p3b`` width (bf16,
``init_params`` seed 0, B=4 x P=256 + 32 greedy tokens, the early-exit
draft at its default cut, k=4) is made with the decode attention of every
Q=4 window reading ``shift`` keys short of its row (the model's call
wrapped in this process; 0 leaves it as it is). Each row prints d, the
largest difference between a spec-off logits row and the spec-on row of
the same token, over every token the streams share and the first they do
not; e, a kernel-path row against the same forward through the plain
decode attention; and whether the rule's limits (``SPEC_D_LIMIT``,
``SPEC_E_LIMIT``) hold. The first line is the card's name and power
limit. Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shifts", default="0,1,64",
                    help="comma-separated keys the Q=4 windows read short")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_spec_margin_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.inference import GenerationSession
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.kernels import _build
    print(cs.gpu_line(), flush=True)
    _build.build()
    smoke = cs.Smoke(torch)
    cfg = gpt.gpt3_1p3b()
    params = gpt.init_params(cfg, seed=0, device=smoke.dev)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 256))
    attend = gpt.decode_attention
    for shift in (int(s) for s in args.shifts.split(",")):
        def short(q, kc, vc, pos, *a, **kw):
            if q.shape[2] == 4:
                pos = (pos - shift).clamp_min(0)
            return attend(q, kc, vc, pos, *a, **kw)

        gpt.decode_attention = short
        captured, undo = smoke._spec_instruments()
        mk = lambda **kw: GenerationSession(
            params, cfg, max_slots=4, max_prompt_len=256, max_len=448,
            device=smoke.dev, **kw)
        off = smoke._spec_streams(mk(), prompt, 32, captured)
        on = smoke._spec_streams(mk(spec_decode=4), prompt, 32, captured)
        rows = smoke._margin_rule(off, on)
        undo()
        gpt.decode_attention = attend
        print("PROBE " + json.dumps(dict(
            keys_short=shift, d_limit=cs.SPEC_D_LIMIT,
            e_limit=cs.SPEC_E_LIMIT, rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

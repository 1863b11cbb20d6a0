"""Subprocess trainer for the port's SIGKILL-resume test
(tests/test_torch_checkpoint_ft.py): a small GPT trained on the CPU with
async checkpoints through ``ft.CheckpointManager``. Per-step data derives
from the step index, so the loss trajectory is a pure function of the
seed and the step range, and a resumed run must reproduce the
uninterrupted run's losses from its last committed step. Prints ONE JSON
line: ``{"start_step": s, "losses": [...], "committed": [...]}``.

Usage: python _torch_ckpt_trainer.py CKPT_DIR [--resume] [--steps N]
       [--save-every K] [--step-sleep-ms MS]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> None:
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed.ft import CheckpointManager, latest_step
    from paddle_tpu_torch.models import gpt

    args = sys.argv[1:]
    ckpt_dir = args[0]
    resume = "--resume" in args

    def opt_arg(flag, default):
        return float(args[args.index(flag) + 1]) if flag in args else default

    n_steps = int(opt_arg("--steps", 12))
    save_every = int(opt_arg("--save-every", 2))
    sleep_ms = opt_arg("--step-sleep-ms", 0.0)

    cfg = gpt.gpt_tiny(n_layers=2, remat=False)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    opt = gpt.adamw_init(params, device="cpu")
    step = gpt.build_train_step(cfg, lr=1e-3, device="cpu")

    def data_for(t):
        tok = np.random.default_rng(5000 + t).integers(0, cfg.vocab_size,
                                                       (2, 17))
        return tok[:, :-1], tok[:, 1:]

    mgr = CheckpointManager(ckpt_dir, keep=3, name="ckpt_trainer")
    start = 0
    if resume and latest_step(ckpt_dir) is not None:
        arrays, aux, s = mgr.restore()
        params, opt = gpt.restore_train_state(arrays, cfg, device="cpu")
        start = int((aux or {}).get("train", {}).get("next_step", s))
    losses, committed = [], []
    for t in range(start, n_steps):
        params, opt, loss = step(params, opt, *data_for(t))
        losses.append(float(loss))
        if save_every and (t + 1) % save_every == 0:
            mgr.save(t + 1, gpt.train_state_arrays(params, opt),
                     {"train": {"next_step": t + 1}})
            committed.append(t + 1)
        if sleep_ms:
            time.sleep(sleep_ms / 1e3)
    mgr.wait()
    print(json.dumps({"start_step": start, "losses": losses,
                      "committed": committed}))


if __name__ == "__main__":
    main()

"""paddle_tpu_torch.distributed.ft — fault-tolerant training and the chaos
plan, ported from paddle_tpu.distributed.ft.

- :mod:`.atomic` — the tmp-dir + fsync + rename commit protocol: a crash
  can never corrupt the newest complete checkpoint.
- :mod:`.reshard` — slice arithmetic over flat ZeRO-3 buckets.
- :mod:`.manager` — :class:`CheckpointManager`: device-to-host copy in
  the caller's thread, background numpy write, atomic commit, ``keep=``
  pruning, and the SIGTERM/deadline preemption hook.
- :mod:`.sentinel` — the anomaly test of a guarded train step and the
  :class:`StepGuard` host policy: skip, rollback (restore the last
  commit), quarantine.
- :mod:`.chaos` — the deterministic fault-plan DSL
  (``PADDLE_TPU_CHAOS=nan_grad@step=7,...``), its training and serving
  faults.
"""
from __future__ import annotations

from . import atomic, chaos, reshard, sentinel
from .chaos import ChaosPlan, plan_from_env
from .manager import (CheckpointManager, PreemptionHandler, all_steps,
                      install_preemption_handler, latest_step)
from .sentinel import StepGuard, run_guarded

__all__ = [
    "atomic", "chaos", "reshard", "sentinel",
    "CheckpointManager", "PreemptionHandler",
    "install_preemption_handler", "latest_step", "all_steps",
    "StepGuard", "run_guarded", "ChaosPlan", "plan_from_env",
]

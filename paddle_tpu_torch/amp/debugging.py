"""paddle.amp.debugging: port of paddle_tpu/amp/debugging.py.

Numerical-debugging tools for mixed precision. Reference surface: python/paddle/amp/debugging.py:37 (DebugMode),
:79 (TensorCheckerConfig), :314/:351/:393 (operator stats collection),
:428 (compare_accuracy), :489/:530 (enable/disable_tensor_checker).
The reference drives these through FLAGS_check_nan_inf + per-op C++ scans
(framework/details/nan_inf_utils_detail.cc); here the single eager
dispatch point (tensor.apply_op) calls its observers with each op's name
and output values (torch tensors), so the checker and the stats
collector are ordinary Python observers.
"""
from __future__ import annotations

import contextlib
import csv
import json
import os
import random
from enum import Enum

import numpy as np
import torch

from ..framework.dtype import from_torch


def _dtype_name(v) -> str:
    """The reference's dtype name of a value's torch dtype."""
    return str(np.dtype(from_torch(v.dtype)))


def _numpy64(v) -> np.ndarray:
    return v.detach().to("cpu", torch.float64).numpy()


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3
    CHECK_ALL_PRINT_AND_SAVE = 4
    CHECK_ALL_ABORT = 5
    DUMP_ALL = 6


class TensorCheckerConfig:
    """Configuration for the per-op output checker (reference
    amp/debugging.py:79). ``checked_op_list`` / ``skipped_op_list`` filter
    by op name; ``output_dir`` additionally dumps per-op stats as JSONL
    (consumed by :func:`compare_accuracy`)."""

    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1, initial_seed=123):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])
        self.debug_step = debug_step      # (start, end) step range or None
        self.stack_height_limit = stack_height_limit
        self.initial_seed = initial_seed
        self._step = 0
        self._dump_fh = None
        if enable:
            self._set_seed()

    def _set_seed(self):
        from ..framework import random as _random
        _random.seed(self.initial_seed)
        random.seed(self.initial_seed)
        np.random.seed(self.initial_seed % (2 ** 32))

    def update_and_check_step_id(self):
        """Advance the step counter (called automatically from
        Optimizer.step while a checker is active) and report whether the
        new step falls inside ``debug_step``."""
        self._step += 1
        return self._step_in_range()

    def _step_in_range(self):
        if self.debug_step is None:
            return True
        lo, hi = self.debug_step
        return lo <= self._step <= hi

    def _should_check(self, op_name):
        if not self._step_in_range():
            return False
        if self.skipped_op_list and op_name in self.skipped_op_list:
            return False
        if self.checked_op_list:
            return op_name in self.checked_op_list
        return True


_active_config: TensorCheckerConfig | None = None


def set_checked_op_list(checked_op_list):
    if _active_config is not None:
        _active_config.checked_op_list = set(checked_op_list or [])


def set_skipped_op_list(skipped_op_list):
    if _active_config is not None:
        _active_config.skipped_op_list = set(skipped_op_list or [])


def _tensor_stats(v):
    vf = _numpy64(v)
    finite = vf[np.isfinite(vf)]
    return {
        "num_nan": int(np.isnan(vf).sum()),
        "num_inf": int(np.isinf(vf).sum()),
        "min": float(finite.min()) if finite.size else None,
        "max": float(finite.max()) if finite.size else None,
        "mean": float(finite.mean()) if finite.size else None,
    }


def check_numerics(tensor, op_type="unknown", var_name="unknown",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """Scan one tensor for NaN/Inf (reference debugging.check_numerics).
    Returns (num_nan, num_inf, num_zero) tensors; raises under ABORT
    modes when a NaN/Inf is present."""
    from ..tensor import Tensor
    v = tensor._value if isinstance(tensor, Tensor) else torch.as_tensor(
        np.asarray(tensor))
    vf = _numpy64(v)
    num_nan = int(np.isnan(vf).sum())
    num_inf = int(np.isinf(vf).sum())
    num_zero = int((vf == 0).sum())
    if num_nan or num_inf:
        msg = (f"[check_numerics] op={op_type} var={var_name}: "
               f"{num_nan} NaN, {num_inf} Inf")
        if debug_mode in (DebugMode.CHECK_NAN_INF_AND_ABORT,
                          DebugMode.CHECK_ALL_ABORT):
            raise FloatingPointError(msg)
        print(msg)
    dev = v.device
    return tuple(Tensor(torch.tensor(n, dtype=torch.int32, device=dev))
                 for n in (num_nan, num_inf, num_zero))


def _checker_observer(op_name, leaves):
    cfg = _active_config
    if cfg is None or not cfg.enable or not cfg._should_check(op_name):
        return
    for v in leaves:
        if not (isinstance(v, torch.Tensor) and (v.is_floating_point()
                                                  or v.is_complex())):
            continue
        if cfg._dump_fh is not None:
            stats = _tensor_stats(v)
            rec = {"op": op_name, "dtype": _dtype_name(v), **stats}
            cfg._dump_fh.write(json.dumps(rec) + "\n")
            num_nan, num_inf = stats["num_nan"], stats["num_inf"]
        else:
            # no dump: only the counts are needed — keep them on device
            num_nan = int(torch.isnan(v).sum())
            num_inf = int(torch.isinf(v).sum())
        if num_nan or num_inf:
            msg = (f"[tensor_checker] NaN/Inf in output of '{op_name}': "
                   f"{num_nan} NaN, {num_inf} Inf")
            if cfg.debug_mode in (DebugMode.CHECK_NAN_INF_AND_ABORT,
                                  DebugMode.CHECK_ALL_ABORT):
                raise FloatingPointError(msg)
            print(msg)


def enable_tensor_checker(checker_config=None):
    """Install the per-op NaN/Inf checker (reference debugging.py:489)."""
    global _active_config
    from .. import tensor as _tensor_mod
    if _active_config is not None and _active_config._dump_fh:
        _active_config._dump_fh.close()
        _active_config._dump_fh = None
    cfg = checker_config or TensorCheckerConfig()
    _active_config = cfg
    if cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        cfg._dump_fh = open(os.path.join(cfg.output_dir, "tensor_stats.jsonl"),
                            "w")
    if _checker_observer not in _tensor_mod._dispatch_observers:
        _tensor_mod._dispatch_observers.append(_checker_observer)


def disable_tensor_checker():
    global _active_config
    from .. import tensor as _tensor_mod
    if _checker_observer in _tensor_mod._dispatch_observers:
        _tensor_mod._dispatch_observers.remove(_checker_observer)
    if _active_config is not None and _active_config._dump_fh:
        _active_config._dump_fh.close()
        _active_config._dump_fh = None
    _active_config = None


# ---------------------------------------------------------------------------
# operator stats collection (reference debugging.py:314-427)
# ---------------------------------------------------------------------------
_op_stats: dict | None = None


def _stats_observer(op_name, leaves):
    if _op_stats is None:
        return
    for v in leaves:
        if isinstance(v, torch.Tensor):
            key = (op_name, _dtype_name(v))
            _op_stats[key] = _op_stats.get(key, 0) + 1


def enable_operator_stats_collection():
    """Start counting (op, output dtype) dispatch frequencies."""
    global _op_stats
    from .. import tensor as _tensor_mod
    _op_stats = {}
    if _stats_observer not in _tensor_mod._dispatch_observers:
        _tensor_mod._dispatch_observers.append(_stats_observer)


def disable_operator_stats_collection():
    """Stop collection and print the table (reference prints four dtype
    columns: FP16/BF16/FP32/other calls per op)."""
    global _op_stats
    from .. import tensor as _tensor_mod
    if _stats_observer in _tensor_mod._dispatch_observers:
        _tensor_mod._dispatch_observers.remove(_stats_observer)
    stats, _op_stats = _op_stats or {}, None
    _print_operator_stats(stats)
    return stats


def _print_operator_stats(stats):
    by_op: dict = {}
    for (op, dtype), n in stats.items():
        by_op.setdefault(op, {})[dtype] = n
    cols = ["float16", "bfloat16", "float32", "other"]
    print(f"{'op':<28}" + "".join(f"{c:>10}" for c in cols))
    for op in sorted(by_op):
        row = {"other": 0}
        for dtype, n in by_op[op].items():
            if dtype in cols:
                row[dtype] = row.get(dtype, 0) + n
            else:
                row["other"] += n
        print(f"{op:<28}" + "".join(
            f"{row.get(c, 0):>10}" for c in cols))


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Join two tensor_stats.jsonl dumps (e.g. an fp32 run and an amp run
    of the same program) op-occurrence by op-occurrence and write a CSV
    flagging NaN/Inf and max/mean divergence (reference debugging.py:428
    writes an .xlsx; CSV keeps it dependency-free)."""
    def load(path):
        fname = path if path.endswith(".jsonl") else os.path.join(
            path, "tensor_stats.jsonl")
        with open(fname) as f:
            recs = [json.loads(line) for line in f]
        # amp runs interleave autocast dispatches the fp32 run lacks:
        # drop them so the op streams align (the documented use case is
        # fp32-vs-amp comparison)
        return [r for r in recs if r["op"] != "amp_cast"]

    a_recs, b_recs = load(dump_path), load(another_dump_path)
    rows = []
    if len(a_recs) != len(b_recs):
        rows.append({
            "idx": -1, "op_a": f"<{len(a_recs)} records>",
            "op_b": f"<{len(b_recs)} records>", "dtype_a": "", "dtype_b": "",
            "max_a": None, "max_b": None, "mean_a": None, "mean_b": None,
            "nan_a": 0, "nan_b": 0, "inf_a": 0, "inf_b": 0,
            "flag": "length-mismatch",
        })
    for i, (a, b) in enumerate(zip(a_recs, b_recs)):
        flag = ""
        if a["op"] != b["op"]:
            flag = "op-mismatch"
        elif (a["num_nan"], a["num_inf"]) != (b["num_nan"], b["num_inf"]):
            flag = "nan-inf-divergence"
        elif a["max"] is not None and b["max"] is not None:
            denom = max(abs(a["max"]), 1e-10)
            if abs(a["max"] - b["max"]) / denom > 1e-1:
                flag = "max-divergence"
        rows.append({
            "idx": i, "op_a": a["op"], "op_b": b["op"],
            "dtype_a": a["dtype"], "dtype_b": b["dtype"],
            "max_a": a["max"], "max_b": b["max"],
            "mean_a": a["mean"], "mean_b": b["mean"],
            "nan_a": a["num_nan"], "nan_b": b["num_nan"],
            "inf_a": a["num_inf"], "inf_b": b["num_inf"],
            "flag": flag,
        })
    with open(output_filename, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()) if rows
                                else ["idx"])
        writer.writeheader()
        writer.writerows(rows)
    return rows


def _on_optimizer_step():
    """Advance the active checker's step counter (hook called from
    Optimizer.step)."""
    if _active_config is not None:
        _active_config.update_and_check_step_id()

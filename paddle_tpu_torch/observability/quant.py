"""Quantized-serving byte accounting: the port of
paddle_tpu/observability/quant.py.

:func:`record_session_quant` is called by every ``GenerationSession`` that
arms weight-only quantization and/or the scaled-int8 KV cache. With
telemetry on it also publishes the ``quant_<session>_*`` gauges (weight
and KV bit widths, quantized weight bytes and the bytes saved, KV bytes
per row) and one ``serving_quant`` JSONL event carrying the same numbers.
"""
from __future__ import annotations

from ..framework.monitor import stat_registry
from ..quantization.gpt_quant import (W_BITS, kv_cache_quantized,
                                      quant_param_stats, tree_bytes)
from . import events

__all__ = ["record_session_quant"]


def record_session_quant(name: str, cfg, params, caches,
                         max_slots: int) -> dict:
    """The quant byte accounting of session ``name``: weight and KV bit
    widths (0 = that lane off), the quantized weight bytes and the bytes
    saved against the same elements at ``cfg.dtype``, and the K+V cache
    bytes per serving slot (codes and step planes)."""
    w_bits = W_BITS.get(cfg.weight_quant, 0)
    kv_bits = 8 if kv_cache_quantized(cfg) else 0
    stats = {"weight_bits": w_bits, "kv_bits": kv_bits}
    if w_bits:
        stats.update(quant_param_stats(params, cfg))
    stats["kv_bytes_per_row"] = tree_bytes(caches) // max(1, max_slots)
    events.emit("serving_quant", name=name, weight_quant=cfg.weight_quant,
                kv_cache=("int8" if kv_bits else
                          str(cfg.kv_cache_dtype or cfg.dtype)), **stats)
    if events.enabled():
        p, reg = f"quant_{name}", stat_registry.register
        reg(f"{p}_weight_bits").set(w_bits)
        reg(f"{p}_kv_bits").set(kv_bits)
        reg(f"{p}_kv_bytes_per_row").set(stats["kv_bytes_per_row"])
        if w_bits:
            reg(f"{p}_weight_bytes").set(stats["quant_weight_bytes"])
            reg(f"{p}_weight_bytes_saved").set(stats["weight_bytes_saved"])
    return stats

"""Quantized-serving byte accounting (the stats half of
paddle_tpu/observability/quant.py; its gauges and the ``serving_quant``
JSONL event come with the telemetry slice).

:func:`record_session_quant` is called by every ``GenerationSession`` that
arms weight-only quantization and/or the scaled-int8 KV cache.
"""
from __future__ import annotations

from ..quantization.gpt_quant import (W_BITS, kv_cache_quantized,
                                      quant_param_stats, tree_bytes)

__all__ = ["record_session_quant"]


def record_session_quant(cfg, params, caches, max_slots: int) -> dict:
    """The quant byte accounting of one session: weight and KV bit widths
    (0 = that lane off), the quantized weight bytes and the bytes saved
    against the same elements at ``cfg.dtype``, and the K+V cache bytes
    per serving slot (codes and step planes)."""
    w_bits = W_BITS.get(cfg.weight_quant, 0)
    kv_bits = 8 if kv_cache_quantized(cfg) else 0
    stats = {"weight_bits": w_bits, "kv_bits": kv_bits}
    if w_bits:
        stats.update(quant_param_stats(params, cfg))
    stats["kv_bytes_per_row"] = tree_bytes(caches) // max(1, max_slots)
    return stats

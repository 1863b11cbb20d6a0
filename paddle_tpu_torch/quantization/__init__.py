"""Weight-only and KV-cache quantization for GPT serving (port of
paddle_tpu/quantization/gpt_quant.py; the reference package's eager
QAT/PTQ flows are not ported)."""
from .gpt_quant import (W_BITS, dequant_rows, kv_cache_quantized,
                        pack_int4, quant_param_stats, quantize_gpt_params,
                        quantize_rows, quantize_weight, tree_bytes,
                        unpack_int4, wq_einsum)

__all__ = [
    "W_BITS", "quantize_weight", "pack_int4", "unpack_int4",
    "quantize_gpt_params", "wq_einsum", "dequant_rows", "quantize_rows",
    "quant_param_stats", "kv_cache_quantized", "tree_bytes",
]

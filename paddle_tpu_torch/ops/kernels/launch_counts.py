"""The kernel wrappers' launch counters, read and added as one vector.

Every wrapper counts its launches in ``fn.launches``; quant_matmul also
by route (``fn.routes``) and the decode-attention forms by window width
(``fn.by_q``). A replayed CUDA graph launches its kernels without calling
a wrapper, so the code that captures one (``framework.cuda_graph``) takes
a :func:`snapshot` before and after the capture, puts the counters back
(:func:`restore`: a capture runs nothing) and keeps the :func:`diff` as
the graph's launch vector, which :func:`add` adds once a replay. The
counters then count the launches the device ran, graphed or not.
"""
from __future__ import annotations

# the per-kernel breakdowns a wrapper may keep beside ``launches``
_BREAKDOWNS = ("routes", "by_q")


def counters() -> dict:
    """``{kernel name: wrapper}`` of every counted kernel wrapper."""
    from . import flash_attention as fa
    from . import primitives as prim
    from .decode_attention import (decode_attention, decode_attention_paged,
                                   decode_attention_paged_q8,
                                   decode_attention_q8)
    from .fused_adamw import fused_adamw_update
    from .fused_residual_ln import fused_bias_dropout_residual_ln
    from .quant_matmul import quant_matmul
    return {"flash_attention_fwd": fa.flash_attention,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "decode_attention": decode_attention,
            "fused_adamw": fused_adamw_update,
            "quant_matmul": quant_matmul,
            "decode_attention_q8": decode_attention_q8,
            "decode_attention_paged": decode_attention_paged,
            "decode_attention_paged_q8": decode_attention_paged_q8,
            "fused_residual_ln": fused_bias_dropout_residual_ln,
            "elementwise_kernel": prim.elementwise_kernel,
            "reduce_kernel": prim.reduce_kernel}


def snapshot() -> dict:
    """Every counter: ``{(name, None): launches, (name, (attr, key)):
    breakdown count}``."""
    out = {}
    for name, fn in counters().items():
        out[(name, None)] = fn.launches
        for attr in _BREAKDOWNS:
            for key, n in getattr(fn, attr, {}).items():
                out[(name, (attr, key))] = n
    return out


def diff(before: dict, after: dict) -> dict:
    """The counts ``after`` adds to ``before``, non-zero entries only."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def add(vec: dict, sign: int = 1) -> None:
    """Add a launch vector (``sign=-1``: take it away) to the counters."""
    fns = counters()
    for (name, part), n in vec.items():
        fn = fns[name]
        if part is None:
            fn.launches += sign * n
        else:
            attr, key = part
            table = getattr(fn, attr)
            table[key] = table.get(key, 0) + sign * n


def restore(snap: dict) -> None:
    """Set every counter back to a :func:`snapshot`."""
    add(diff(snap, snapshot()), sign=-1)


def zero() -> None:
    """Every counter and breakdown to 0 (the breakdowns keep their
    keys)."""
    for fn in counters().values():
        fn.launches = 0
        for attr in _BREAKDOWNS:
            if hasattr(fn, attr):
                setattr(fn, attr, dict.fromkeys(getattr(fn, attr), 0))

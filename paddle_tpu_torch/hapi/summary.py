"""Model summary and flops: port of paddle_tpu/hapi/summary.py (reference:
hapi/model_summary.py, hapi/dynamic_flops.py)."""
from __future__ import annotations

from ..nn.layer import Layer


def summary(net: Layer, input_size=None, dtypes=None, input=None):
    rows = []
    total_params = 0
    trainable = 0
    for name, layer in net.named_sublayers(include_self=True):
        n_params = sum(p.size for p in layer.parameters(include_sublayers=False))
        if not n_params and layer.sublayers():
            continue
        for p in layer.parameters(include_sublayers=False):
            total_params += p.size
            if not p.stop_gradient:
                trainable += p.size
        rows.append((name or layer.__class__.__name__,
                     layer.__class__.__name__, n_params))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Layer':{width}s}{'Type':24s}{'Params':>12s}",
             "-" * (width + 36)]
    for name, cls, n in rows:
        lines.append(f"{name:{width}s}{cls:24s}{n:>12,d}")
    lines.append("-" * (width + 36))
    lines.append(f"Total params: {total_params:,d}")
    lines.append(f"Trainable params: {trainable:,d}")
    lines.append(f"Non-trainable params: {total_params - trainable:,d}")
    print("\n".join(lines))
    return {"total_params": total_params, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Multiply-adds x 2 of one eval forward on zeros of ``input_size``,
    counted by ``torch.utils.flop_counter`` (the reference asks XLA's cost
    analysis); 0 when the forward cannot run on that input."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..framework.place import current_device
    from ..jit.functional import collect_state, make_pure_fn
    try:
        params, buffers = collect_state(net)
        pure = make_pure_fn(net, training=False)
        x = torch.zeros(tuple(input_size), dtype=torch.float32,
                        device=current_device())
        with FlopCounterMode(display=False) as counter:
            pure({k: p._value for k, p in params.items()},
                 {k: b._value for k, b in buffers.items()}, 0, (x,), {})
        return int(counter.get_total_flops())
    except Exception:  # noqa: BLE001 — as the reference: 0 when it fails
        return 0

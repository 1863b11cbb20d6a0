"""Fused AdamW: the CUDA kernel ``csrc/fused_adamw.cu`` and its plain
PyTorch version.

Port of paddle_tpu/ops/pallas/fused_adamw.py. One launch per leaf reads
p, g, m and v once and writes p, m and v, in f32 math whatever p's dtype
(bf16 params keep f32 moments). On CUDA the kernel updates p, m and v IN
PLACE, where the reference returned new arrays and relied on buffer
donation to reuse their memory: in place keeps one copy of the optimizer
state resident instead of two during the update.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import resolve_device
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tree_flatten(tree) -> list:
    """Leaves of a nested dict in sorted-key order (the order
    ``jax.tree_util`` gives a dict)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_flatten(tree[key])]
    return [tree]


def tree_unflatten(like, leaves):
    """A nested dict shaped as ``like`` holding ``leaves`` (an iterable in
    :func:`tree_flatten` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(like)


def reference_update(p, g, m, v, scalars, wd):
    """Plain version, port of ``_reference_update``: scalars is the [7] f32
    tensor ``[lr, b1, b2, eps, 1-b1^t, 1-b2^t, grad_scale]``. Returns new
    (p in its dtype, m, v in f32)."""
    lr, b1, b2, eps, bc1, bc2, gs = scalars.unbind(0)
    pf = p.float()
    gf = g.float() * gs
    m2 = b1 * m + (1.0 - b1) * gf
    v2 = b2 * v + (1.0 - b2) * gf * gf
    upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    p2 = pf - lr * (upd + wd * pf)
    return p2.to(p.dtype), m2, v2


def _f32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32).reshape(())
    # a fill kernel, not a host-to-device copy: nothing waits on the host
    return torch.full((), float(x), dtype=torch.float32, device=device)


def adamw_scalars(step, lr, b1, b2, eps, grad_scale, device) -> torch.Tensor:
    """The kernel's [7] f32 operand on ``device``, built by device ops from
    the int step counter (``t = step + 1``), so the host never reads the
    step back."""
    t = torch.as_tensor(step, device=device).to(torch.float32) + 1.0
    b1t, b2t = _f32(b1, device), _f32(b2, device)
    return torch.stack([_f32(lr, device), b1t, b2t, _f32(eps, device),
                        1.0 - b1t ** t, 1.0 - b2t ** t,
                        _f32(1.0 if grad_scale is None else grad_scale,
                             device)])


def _lib():
    fn = _build.load("fused_adamw").fused_adamw
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_leaf(p, g, m, v, device):
    for t in (p, g, m, v):
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"fused_adamw_update runs on {device}, got a "
                             f"leaf on {t.device}")
    if p.dtype not in _DTYPES or g.dtype != p.dtype \
            or m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"fused_adamw kernel takes p bf16 or f32, g in p's "
                         f"dtype and f32 moments; got p {p.dtype}, g "
                         f"{g.dtype}, m {m.dtype}, v {v.dtype}")
    if not (g.shape == m.shape == v.shape == p.shape):
        raise ValueError(f"fused_adamw leaf shapes differ: p {tuple(p.shape)}"
                         f", g {tuple(g.shape)}, m {tuple(m.shape)}, v "
                         f"{tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("fused_adamw kernel needs contiguous leaves")


def fused_adamw_update(params, grads, m, v, step, lr, wd=0.01, b1=0.9,
                       b2=0.999, eps=1e-8, grad_scale=None, device=None):
    """Tree-level fused AdamW step over nested dicts of tensors. Returns
    (params, m, v) trees.

    ``step`` is the int step counter before this update (a tensor on the
    device or an int); ``grad_scale`` (a number or a 0-d tensor) multiplies
    the gradient inside the kernel. CPU leaves run
    :func:`reference_update` and get new tensors; CUDA leaves launch the
    kernel once each and are updated in place; anything else raises."""
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_adamw_update: no kernel for {dev}")
    scalars = adamw_scalars(step, lr, b1, b2, eps, grad_scale, dev)
    leaves = [tree_flatten(t) for t in (params, grads, m, v)]
    if len({len(x) for x in leaves}) != 1:
        raise ValueError("params, grads, m and v trees differ in size")
    out_p, out_m, out_v = [], [], []
    for p, g, mm, vv in zip(*leaves):
        _check_leaf(p, g, mm, vv, dev)
        if dev.type == "cpu":
            p2, m2, v2 = reference_update(p.reshape(-1), g.reshape(-1),
                                          mm.reshape(-1), vv.reshape(-1),
                                          scalars, wd)
            p2, m2, v2 = (t.reshape(p.shape) for t in (p2, m2, v2))
        else:
            err = _lib()(p.data_ptr(), g.data_ptr(), mm.data_ptr(),
                         vv.data_ptr(), scalars.data_ptr(), float(wd),
                         p.numel(), _DTYPES[p.dtype],
                         torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "fused_adamw")
            fused_adamw_update.launches += 1
            p2, m2, v2 = p, mm, vv
        out_p.append(p2)
        out_m.append(m2)
        out_v.append(v2)
    return (tree_unflatten(params, out_p), tree_unflatten(params, out_m),
            tree_unflatten(params, out_v))


fused_adamw_update.launches = 0

"""Gradient clipping: port of paddle_tpu/nn/clip.py (reference:
python/paddle/nn/clip.py — ClipGradByGlobalNorm, ClipGradByNorm,
ClipGradByValue). A clip maps ``[(param, grad)]`` to clipped pairs; the
grads are Tensors."""
from __future__ import annotations

import torch

from ..tensor import Tensor, _val


def _skip(p, g):
    return g is None or (hasattr(p, "need_clip") and not p.need_clip)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g) if _skip(p, g) else
                (p, Tensor(torch.clamp(_val(g), self.min, self.max)))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            gv = _val(g)
            norm = torch.sqrt(torch.sum(torch.square(gv)))
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
            out.append((p, Tensor(gv * scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        sq = [torch.sum(torch.square(_val(g).float()))
              for p, g in params_grads if not _skip(p, g)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(sum(sq))
        scale = self.clip_norm / torch.clamp_min(global_norm, self.clip_norm)
        return [(p, g) if _skip(p, g) else
                (p, Tensor((_val(g).float() * scale).to(_val(g).dtype)))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """paddle.nn.utils.clip_grad_norm_: scales the grads in place; returns
    the total norm."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p._value.grad for p in parameters if p.grad is not None]
    if not grads:
        return Tensor(torch.zeros(()))
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([torch.sum(g.abs() ** norm_type)
                             for g in grads]).sum() ** (1.0 / norm_type)
    coef = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(coef)
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p._value.grad.clamp_(-clip_value, clip_value)

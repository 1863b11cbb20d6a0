"""GradScaler with dynamic loss scaling: port of
paddle_tpu/amp/grad_scaler.py (reference: python/paddle/amp/
grad_scaler.py). float16 training needs it; bfloat16 has f32's exponent
range."""
from __future__ import annotations

import torch

from ..tensor import Tensor


def _tree_found_inf(grads) -> bool:
    """ONE host read for the whole gradient list: each leaf's finiteness
    folds into one device-side bool (``all(isfinite(leaf))`` per leaf,
    AND-reduced), and only that crosses to the host."""
    finite = None
    for g in grads:
        leaf_ok = torch.isfinite(g).all()
        finite = leaf_ok if finite is None else finite & leaf_ok
    if finite is None:
        return False
    return not bool(finite)   # the single read


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var: Tensor) -> Tensor:
        if not self._enable:
            return var
        from ..ops import math as m
        return m.scale(var, scale=self._scale)

    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        unscaled = []
        with torch.no_grad():
            for p in optimizer._parameters_flat:
                if p.grad is None:
                    continue
                g = p._value.grad
                g.mul_(inv)
                unscaled.append(g)
        self._found_inf = _tree_found_inf(unscaled)
        if self._found_inf:
            from ..observability import events as _ev
            _ev.emit("amp_found_inf", scale=self._scale)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "found_inf": self._found_inf}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
        # a scaler restored between unscale_ and update() keeps the bad
        # step it saw
        self._found_inf = bool(state.get("found_inf", False))

    set_state_dict = load_state_dict


AmpScaler = GradScaler

"""Optimizer base + SGD/Momentum: port of paddle_tpu/optimizer/optimizer.py
(reference: ``python/paddle/optimizer/optimizer.py`` — accumulators, param
groups, regularizer and grad-clip hooks).

Each optimizer defines two functions of torch tensors, ``init_state`` and
``update``, as the reference defines them over jnp arrays; ``step()`` maps
them over the parameters with grads and writes each result into the
parameter in place (its torch value keeps its identity). The update is
stock torch ops, as the reference's eager update is XLA ops: the fused
AdamW kernel belongs to the functional train step, not to this path.
``multi_precision`` keeps f32 master weights for bf16/f16 parameters.
"""
from __future__ import annotations

import torch

from ..tensor import Parameter, Tensor, _val
from .lr import LRScheduler


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * p


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * torch.sign(p)


def _to_regularizer(weight_decay):
    if weight_decay is None:
        return None
    if isinstance(weight_decay, (int, float)):
        return L2Decay(weight_decay)
    return weight_decay


class Optimizer:
    # subclasses override
    _accumulator_names: tuple[str, ...] = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._learning_rate = learning_rate
        self._parameter_list = self._build_param_groups(parameters)
        self.regularization = _to_regularizer(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._states: dict[int, dict] = {}
        self._step_count = 0

    # ---- param groups ----------------------------------------------------
    def _build_param_groups(self, parameters):
        if parameters is None:
            return []
        params = list(parameters)
        if params and isinstance(params[0], dict):
            groups = []
            for g in params:
                g = dict(g)
                g["params"] = list(g["params"])
                groups.append(g)
            return groups
        return [{"params": params}]

    @property
    def _all_params(self):
        for g in self._parameter_list:
            wd = _to_regularizer(g.get("weight_decay")) or self.regularization
            lr_factor = g.get("learning_rate", 1.0)
            for p in g["params"]:
                yield p, wd, lr_factor

    # ---- lr --------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ---- update rule (override) -----------------------------------------
    def init_state(self, p_val: torch.Tensor) -> dict:
        return {}

    def update(self, p_val, g_val, state: dict, lr, step) -> tuple:
        raise NotImplementedError

    # ---- step ------------------------------------------------------------
    def _state_for(self, p: Parameter):
        sid = id(p)
        if sid not in self._states:
            v = p._value.detach()
            low = v.dtype in (torch.bfloat16, torch.float16)
            st = self.init_state(v.float() if self._multi_precision else v)
            if self._multi_precision and low:
                st["master"] = v.float().clone()
            self._states[sid] = st
        return self._states[sid]

    @staticmethod
    def _write(p, new):
        p._value.copy_(new.to(p._value.dtype))

    def _apply(self, p, g, st, eff_lr, decay=None):
        """One parameter's update (on its f32 master when it has one),
        written back in place; ``decay`` is AdamW's decoupled factor."""
        if "master" in st:
            sub = {k: v for k, v in st.items() if k != "master"}
            src = st["master"]
            if decay is not None:
                src = src * decay
            new, new_sub = self.update(src, g.float(), sub, eff_lr,
                                       self._step_count)
            st.update(new_sub)
            st["master"] = new
        else:
            src = p._value.detach()
            if decay is not None:
                src = src * decay
            new, new_st = self.update(src, g, st, eff_lr, self._step_count)
            self._states[id(p)] = new_st
        self._write(p, new)

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        lr = self.get_lr()
        params_grads, factors = [], []
        for p, wd, lr_factor in self._all_params:
            if p.stop_gradient or p.grad is None:
                continue
            g = _val(p.grad)
            reg = getattr(p, "regularizer", None) or wd
            if reg is not None:
                g = reg(p._value.detach().to(g.dtype), g)
            params_grads.append((p, Tensor._wrap(g, True)))
            factors.append(lr_factor)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        for (p, g), lr_factor in zip(params_grads, factors):
            eff_lr = lr * lr_factor * p.optimize_attr.get("learning_rate",
                                                          1.0)
            self._apply(p, _val(g), self._state_for(p), eff_lr)

    def clear_grad(self, set_to_zero: bool = False):
        for p, _, _ in self._all_params:
            p.clear_gradient(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # ---- state dict ------------------------------------------------------
    def state_dict(self):
        out = {}
        for p, _, _ in self._all_params:
            for k, v in self._states.get(id(p), {}).items():
                out[f"{p.name}_{k}"] = Tensor(v) \
                    if isinstance(v, torch.Tensor) else v
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for p, _, _ in self._all_params:
            st = {}
            for name in list(self._accumulator_names) + ["master",
                                                         "moment2_max"]:
                key = f"{p.name}_{name}"
                if key in state_dict:
                    v = state_dict[key]
                    v = _val(v) if isinstance(v, Tensor) else torch.as_tensor(v)
                    st[name] = v.to(p._value.device)
            if st:
                self._states[id(p)] = st

    def get_opti_var_name_list(self):
        return list(self.state_dict().keys())


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def update(self, p, g, state, lr, step):
        return p - lr * g.to(p.dtype), state


class Momentum(Optimizer):
    _accumulator_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        g = g.to(p.dtype)
        v = self._momentum * state["velocity"] + g
        if self._use_nesterov:
            return p - lr * (g + self._momentum * v), {"velocity": v}
        return p - lr * v, {"velocity": v}

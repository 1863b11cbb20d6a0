"""Adaptive optimizers: port of paddle_tpu/optimizer/adam.py (reference:
python/paddle/optimizer/{adam,adamw,adamax,adagrad,adadelta,rmsprop,
lamb}.py). Update rules over torch tensors, in the reference's order of
operations, so an eager step rounds as the reference's eager step does."""
from __future__ import annotations

import torch

from ..tensor import _val
from .optimizer import Optimizer


class Adam(Optimizer):
    _accumulator_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def init_state(self, p):
        st = {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}
        if self._amsgrad:
            st["moment2_max"] = torch.zeros_like(p)
        return st

    def update(self, p, g, state, lr, step):
        g = g.to(p.dtype)
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * torch.square(g)
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        new = {"moment1": m, "moment2": v}
        if self._amsgrad:
            vmax = torch.maximum(state["moment2_max"], vhat)
            new["moment2_max"] = vmax
            vhat = vmax
        return p - lr * mhat / (torch.sqrt(vhat) + self._epsilon), new


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py):
    each parameter is scaled by ``1 - lr * decay`` before the Adam
    update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name, amsgrad=amsgrad)
        self._wd_coeff = float(weight_decay) if not callable(weight_decay) \
            else weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        lr = self.get_lr()
        params_grads = [(p, p.grad, lr_factor)
                        for p, _, lr_factor in self._all_params
                        if not p.stop_gradient and p.grad is not None]
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for p, g, _ in params_grads])
            params_grads = [(p, g, lf) for (p, g), (_, _, lf)
                            in zip(clipped, params_grads)]
        for p, g, lr_factor in params_grads:
            eff_lr = lr * lr_factor * p.optimize_attr.get("learning_rate",
                                                          1.0)
            if self._lr_ratio is not None:
                eff_lr *= float(self._lr_ratio(p))
            decay = self._wd_coeff() if callable(self._wd_coeff) \
                else self._wd_coeff
            if self._apply_decay_param_fun is not None and \
                    not self._apply_decay_param_fun(p.name):
                decay = 0.0
            self._apply(p, _val(g), self._state_for(p), eff_lr,
                        decay=1.0 - eff_lr * decay)


class Adamax(Optimizer):
    _accumulator_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        g = g.to(p.dtype)
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g))
        new_p = p - (lr / (1 - self._beta1 ** step)) * m / (u + self._epsilon)
        return new_p, {"moment": m, "inf_norm": u}


class Adagrad(Optimizer):
    _accumulator_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def update(self, p, g, state, lr, step):
        g = g.to(p.dtype)
        mom = state["moment"] + torch.square(g)
        return p - lr * g / (torch.sqrt(mom) + self._epsilon), \
            {"moment": mom}


class Adadelta(Optimizer):
    _accumulator_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        g = g.to(p.dtype)
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * torch.square(g)
        upd = g * torch.sqrt(state["avg_squared_update"] + eps) \
            / torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + (1 - rho) * torch.square(upd)
        return p - lr * upd, {"avg_squared_grad": asg,
                              "avg_squared_update": asu}


class RMSProp(Optimizer):
    _accumulator_names = ("momentum", "mean_square", "mean_grad")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, p):
        return {"momentum": torch.zeros_like(p),
                "mean_square": torch.zeros_like(p),
                "mean_grad": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        g = g.to(p.dtype)
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * torch.square(g)
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
        else:
            mg = state["mean_grad"]
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * state["momentum"] + lr * g / denom
        return p - mom, {"momentum": mom, "mean_square": ms, "mean_grad": mg}


class Lamb(Optimizer):
    _accumulator_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        g = g.to(p.dtype)
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * torch.square(g)
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        r = mhat / (torch.sqrt(vhat) + self._epsilon) + self._lamb_wd * p
        w_norm = torch.sqrt(torch.sum(torch.square(p)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p - lr * trust * r, {"moment1": m, "moment2": v}

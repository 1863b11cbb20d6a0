"""L-BFGS optimizer (closure-based, full-batch): port of
paddle_tpu/optimizer/lbfgs.py.

Reference: ``python/paddle/optimizer/lbfgs.py`` (history-limited two-loop
recursion with a strong-Wolfe line search). Each closure call is one
forward and backward of the user's model; the two-loop recursion runs
on flat f32 vectors on the parameters' device, and its branch tests read
scalars on the host, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor, to_tensor
from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _flat_params(params):
    return torch.cat([p._value.detach().reshape(-1).float() for p in params])


def _flat_grads(params):
    return torch.cat([
        (p.grad._value if p.grad is not None
         else torch.zeros(p.size, device=p._value.device)
         ).reshape(-1).float() for p in params])


@torch.no_grad()
def _write_back(params, flat):
    """Parameters take consecutive slices of ``flat``, in place (each
    keeps its identity)."""
    off = 0
    for p in params:
        n = p.size
        p._value.copy_(flat[off:off + n].reshape(p._value.shape))
        off += n


def _loss_value(loss):
    return float(loss.numpy() if isinstance(loss, Tensor) else loss)


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.max_iter = max_iter
        self.max_eval = max_eval or max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s, self._y = [], []   # curvature pair history

    def _direction(self, g):
        """Two-loop recursion over the (s, y) history."""
        q = g
        alphas = []
        for s, y in reversed(list(zip(self._s, self._y))):
            rho = 1.0 / torch.clamp_min(torch.dot(y, s), 1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((rho, a, s, y))
        if self._s:
            s, y = self._s[-1], self._y[-1]
            gamma = torch.dot(s, y) / torch.clamp_min(torch.dot(y, y), 1e-10)
            q = q * gamma
        for rho, a, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return -q

    @torch.no_grad()
    def _post_grads(self):
        """Apply weight decay and grad clip to the fresh gradients, as
        Optimizer.step does for the first-order optimizers."""
        params_grads = []
        for p, wd, _ in self._all_params:
            if p.stop_gradient or p.grad is None:
                continue
            g = p.grad._value
            reg = getattr(p, "regularizer", None) or wd
            if reg is not None:
                g = reg(p._value.detach().to(g.dtype), g)
                p.grad = Tensor._wrap(g, True)
            params_grads.append((p, p.grad))
        if self._grad_clip is not None:
            for p, g in self._grad_clip(params_grads):
                p.grad = g

    def step(self, closure):
        """``closure()`` recomputes the loss with gradients and returns it
        (the reference's contract)."""
        params = [p for p, _, _ in self._all_params if not p.stop_gradient]
        lr = self.get_lr()
        user_closure = closure

        def closure():
            loss = user_closure()
            self._post_grads()
            return loss

        loss = closure()
        loss_val = _loss_value(loss)
        g = _flat_grads(params)
        if float(g.abs().max()) <= self.tolerance_grad:
            return loss

        evals = 1
        for _ in range(self.max_iter):
            x0 = _flat_params(params)
            d = self._direction(g)
            # guard: fall back to steepest descent on a non-descent dir
            if float(torch.dot(d, g)) > 0:
                d = -g
            t = lr if self._s else min(1.0, 1.0 / float(g.abs().sum())) * lr

            if self.line_search_fn == "strong_wolfe":
                t, loss_val, g_new, n_ev = self._strong_wolfe(
                    closure, params, x0, d, t, loss_val, g)
                evals += n_ev
            else:
                _write_back(params, x0 + t * d)
                for p in params:
                    p.clear_gradient()
                loss_val = _loss_value(closure())
                g_new = _flat_grads(params)
                evals += 1

            s = _flat_params(params) - x0
            yk = g_new - g
            if float(torch.dot(s, yk)) > 1e-10:
                self._s.append(s)
                self._y.append(yk)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            delta = float(s.abs().max())
            g = g_new
            if (float(g.abs().max()) <= self.tolerance_grad
                    or delta <= self.tolerance_change
                    or evals >= self.max_eval):
                break
        self._step_count += 1
        return to_tensor(np.float32(loss_val), place=params[0].place)

    def _strong_wolfe(self, closure, params, x0, d, t, f0, g0,
                      c1=1e-4, c2=0.9, max_ls=10):
        """Backtracking line search enforcing Armijo + curvature."""
        dg0 = float(torch.dot(g0, d))
        n_ev = 0
        best = (0.0, f0, g0)   # staying put is always admissible
        for _ in range(max_ls):
            _write_back(params, x0 + t * d)
            for p in params:
                p.clear_gradient()
            f = _loss_value(closure())
            n_ev += 1
            g = _flat_grads(params)
            if f < best[1]:   # track the best point seen, not the last
                best = (t, f, g)
            if f > f0 + c1 * t * dg0:      # Armijo fails: shrink
                t *= 0.5
                continue
            if abs(float(torch.dot(g, d))) <= -c2 * dg0:
                break                       # strong Wolfe satisfied
            t *= 2.0                        # curvature weak: extend
        t, f, g = best
        _write_back(params, x0 + t * d)
        return t, f, g, n_ev

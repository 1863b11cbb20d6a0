"""Training callbacks: port of paddle_tpu/hapi/callbacks.py (reference:
python/paddle/hapi/callbacks.py). ``VisualDL`` writes its scalars as
JSONL without the visualdl package; ``WandbCallback`` raises without the
wandb package, as the reference's do."""
from __future__ import annotations

import time


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        pass

    def on_batch_end(self, mode, step, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)
        if name.startswith("on_"):
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose
        self.epochs = None
        self.steps = None

    def on_begin(self, mode, logs=None):
        logs = logs or {}
        self.epochs = logs.get("epochs")
        self.steps = logs.get("steps")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._step_t0 = time.time()
        self._samples = 0

    def on_batch_end(self, mode, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items())
            total = f"/{self.steps}" if self.steps else ""
            print(f"Epoch {self.epoch + 1}/{self.epochs} "
                  f"step {step}{total} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._step_t0
            items = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items())
            print(f"Epoch {epoch + 1}/{self.epochs} done ({dt:.1f}s) - {items}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda cur, best: cur > best + self.min_delta
        else:
            self.better = lambda cur, best: cur < best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self.best is None or self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = self.model._optimizer
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_batch_end(self, mode, step, logs=None):
        if mode == "train" and self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class VisualDL(Callback):
    """Kept for API parity; logs scalars to a JSONL file (no visualdl dep)."""

    def __init__(self, log_dir="./log"):
        self.log_dir = log_dir
        self._step = 0

    def on_batch_end(self, mode, step, logs=None):
        import json
        import os
        os.makedirs(self.log_dir, exist_ok=True)
        self._step += 1
        with open(os.path.join(self.log_dir, f"{mode}.jsonl"), "a") as f:
            f.write(json.dumps({"step": self._step, **(logs or {})}) + "\n")


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer lr when a monitored metric stops improving
    (reference: hapi/callbacks.py ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        self.monitor = monitor
        self.factor = float(factor)
        if self.factor >= 1.0:
            raise ValueError("factor must be < 1.0")
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda cur, best: cur > best + self.min_delta
        else:
            self.better = lambda cur, best: cur < best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.best is None or self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                from ..optimizer.lr import LRScheduler as _Sched
                if isinstance(getattr(opt, "_learning_rate", None), _Sched):
                    import warnings
                    warnings.warn(
                        "ReduceLROnPlateau: optimizer uses an LRScheduler; "
                        "refusing to replace it with a constant (use the "
                        "optimizer.lr.ReduceOnPlateau scheduler instead)")
                    self.cooldown_counter = self.cooldown
                    self.wait = 0
                    return
                lr = opt.get_lr()
                new_lr = max(lr * self.factor, self.min_lr)
                if lr - new_lr > 1e-12:
                    opt._learning_rate = new_lr
                    if self.verbose:
                        print(f"Epoch {epoch}: ReduceLROnPlateau reducing "
                              f"learning rate to {new_lr}.")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class WandbCallback(Callback):
    """Reference: hapi/callbacks.py WandbCallback — logs batch/epoch
    metrics to a wandb run (gated on the wandb package, absent in this
    image)."""

    def __init__(self, project=None, name=None, dir=None, mode=None,
                 job_type=None, **kwargs):
        try:
            import wandb
        except ImportError as e:
            raise ModuleNotFoundError(
                "WandbCallback requires the wandb package") from e
        self._wandb = wandb
        self._init_kwargs = dict(project=project, name=name, dir=dir,
                                 mode=mode, job_type=job_type, **kwargs)
        self._run = None

    def on_train_begin(self, logs=None):
        self._run = self._wandb.init(**{
            k: v for k, v in self._init_kwargs.items() if v is not None})

    def on_batch_end(self, mode, step, logs=None):
        if self._run and mode == "train":
            self._run.log({f"train/{k}": v for k, v in (logs or {}).items()
                           if isinstance(v, (int, float))})

    def on_epoch_end(self, epoch, logs=None):
        if self._run:
            self._run.log({"epoch": epoch, **{
                f"epoch/{k}": v for k, v in (logs or {}).items()
                if isinstance(v, (int, float))}})

    def on_train_end(self, logs=None):
        if self._run:
            self._run.finish()
            self._run = None

"""paddle.optimizer: port of paddle_tpu/optimizer/ (the optimizers, their
decays and the LR schedulers). ``lbfgs`` waits for a later slice."""
from . import lr  # noqa: F401
from .adam import (Adadelta, Adagrad, Adam, Adamax, AdamW,  # noqa: F401
                   Lamb, RMSProp)
from .optimizer import L1Decay, L2Decay, Momentum, Optimizer, SGD  # noqa: F401

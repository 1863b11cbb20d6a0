"""paddle.optimizer: port of paddle_tpu/optimizer/ (the optimizers, their
decays, L-BFGS and the LR schedulers)."""
from . import lr  # noqa: F401
from .adam import (Adadelta, Adagrad, Adam, Adamax, AdamW,  # noqa: F401
                   Lamb, RMSProp)
from .optimizer import L1Decay, L2Decay, Momentum, Optimizer, SGD  # noqa: F401
from .lbfgs import LBFGS  # noqa: F401

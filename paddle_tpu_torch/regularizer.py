"""paddle.regularizer: port of paddle_tpu/regularizer.py."""
from .optimizer.optimizer import L1Decay, L2Decay  # noqa: F401

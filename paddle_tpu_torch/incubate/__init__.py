"""incubate: port of paddle_tpu/incubate (so far ``incubate.nn``'s fused
bias-dropout-residual LayerNorm)."""

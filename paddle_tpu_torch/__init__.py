"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

It serves the flagship GPT on one NVIDIA H100 (``generate()``,
``GenerationSession`` and ``ServingEngine`` over the dense KV cache, with
fp or weight-only int8/int4 weights and an fp or scaled-int8 cache) and
trains it there (``models.gpt.build_train_step``), with hand-written CUDA
kernels for flash attention forward and backward, decode attention (fp
and scaled-int8 caches), the weight-only dequant-matmul, fused AdamW and
the fused bias-dropout-residual LayerNorm of ``incubate.nn``
(``paddle_tpu_torch/csrc``), and the Triton kernel factories of
``ops.kernels.primitives``. Sampling and dropout draw from jax's threefry
PRNG ported bit for bit (``framework.prng``; ``seed`` resets the global
stream). Every entry point runs on the card
unless the caller passes ``device="cpu"``; on the CPU each kernel wrapper
runs its plain PyTorch version. The package imports torch and numpy,
never jax or paddle_tpu.
"""
from .device import resolve_device
from .framework.random import seed

__all__ = ["resolve_device", "seed"]

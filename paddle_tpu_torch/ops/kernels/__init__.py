"""Hand-written CUDA kernels and their plain PyTorch versions.

One module per TPU kernel file: ``flash_attention`` (forward and
backward), ``decode_attention`` (fp and scaled-int8 caches, dense or
paged), ``fused_adamw``, ``quant_matmul``, ``fused_residual_ln`` and
``primitives`` (the Triton kernel factories, ``primitives_triton``). Each
wrapper runs the plain version for a tensor on the CPU, and for a CUDA
tensor launches its kernel (CUDA built from ``paddle_tpu_torch/csrc`` at
first use by ``_build``; Triton compiled at first launch) or raises.
``wrapper.launches`` counts kernel launches; ``launch_counts`` reads and
adds them as one vector (a replayed CUDA graph adds its capture's).
"""

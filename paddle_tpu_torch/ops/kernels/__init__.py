"""Hand-written CUDA kernels and their plain PyTorch versions.

One module per TPU kernel file: ``flash_attention`` (forward and
backward), ``decode_attention`` (fp and scaled-int8 caches, dense or
paged), ``fused_adamw`` and ``quant_matmul``. Each wrapper runs the
plain version for a tensor on the CPU, and for a CUDA tensor launches its
kernel (built from ``paddle_tpu_torch/csrc`` at first use by ``_build``)
or raises. ``wrapper.launches`` counts kernel launches.
"""

"""einsum: port of paddle_tpu/ops/einsum.py (reference:
python/paddle/tensor/einsum.py)."""
from __future__ import annotations

import torch

from ..tensor import def_op


@def_op("einsum")
def einsum(equation, *operands):
    return torch.einsum(equation, *operands)

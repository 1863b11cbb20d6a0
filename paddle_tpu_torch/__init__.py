"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

It serves the flagship GPT on one NVIDIA H100 (``generate()``,
``GenerationSession`` and ``ServingEngine`` over a dense or paged KV
cache, with fp or weight-only int8/int4 weights and an fp or scaled-int8
cache, speculative decoding, captured tick graphs, the resilience plane
with its crash journal, tenant metering, request tracing, and
``ServingFleet`` replicas with prefill/decode handoff) and trains it
there (``models.gpt.build_train_step``, ``remat_policy`` "full" or
"dots", the anomaly sentinel, ``distributed.ft``'s guard, rollback and
checkpoint manager), dense or as a mixture of experts
(``parallel.moe``), with hand-written CUDA
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

The eager framework surface is the reference's front door, so ``import
paddle_tpu_torch as paddle`` reads as paddle: ``Tensor`` over torch
autograd (``to_tensor``, ``no_grad``, ``grad``, ``PyLayer``), the ops,
``nn`` (``Layer`` is a ``torch.nn.Module``), ``optimizer``, ``save`` /
``load``, and ``models.LeNet`` / ``models.gpt.GPT``. New tensors go to the
card unless ``set_device("cpu")`` chose the CPU. Around it the tools of
training and deployment: ``amp`` (``auto_cast`` with the reference's op
lists, ``decorate``, ``GradScaler``, the numerics debugging), ``jit``
(``to_static`` on ``torch.compile``, ``save``/``load`` of a
``torch.export`` program), ``inference.create_predictor``, ``io``
(``DataLoader``, the samplers), ``vision.datasets``, ``metric``, and
``Model`` / ``callbacks`` / ``summary`` / ``flops`` of the high-level API,
``profiler`` (host spans fused with ``torch.profiler``'s device trace),
the recurrent layers, beam search, ``autograd.functional`` and L-BFGS.
"""
from .device import resolve_device  # noqa: F401
from .framework.dtype import (bfloat16, bool_, complex64,  # noqa: F401
                              complex128, convert_dtype, finfo, float16,
                              float32, float64, get_default_dtype, iinfo,
                              int8, int16, int32, int64, set_default_dtype,
                              uint8)
from .framework.dtype import bool_ as bool  # noqa: F401,A001
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.place import (CPUPlace, CUDAPlace, TPUPlace,  # noqa: F401
                              device_count, get_device,
                              is_compiled_with_cuda, set_device)
from .framework.random import (get_rng_state, seed,  # noqa: F401
                               set_rng_state)
from .tensor import (Parameter, Tensor, enable_grad,  # noqa: F401
                     is_grad_enabled, no_grad, set_grad_enabled,
                     set_printoptions, to_tensor)
from .ops import *  # noqa: F401,F403,E402
from .ops import linalg  # noqa: F401,E402
from .ops.einsum import einsum  # noqa: F401,E402
from . import autograd, nn, optimizer  # noqa: F401,E402
from .autograd import PyLayer, grad  # noqa: F401,E402
from .framework.io_state import load, save  # noqa: F401,E402
from . import models  # noqa: F401,E402
from . import amp, io, jit, metric, vision  # noqa: F401,E402
from . import static  # noqa: F401,E402
from .static import disable_static, enable_static  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from . import hapi  # noqa: F401,E402
from .hapi import Model, flops, summary  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from . import profiler, regularizer  # noqa: F401,E402


def in_dynamic_mode() -> bool:
    from .static import _in_static_mode
    return not _in_static_mode()

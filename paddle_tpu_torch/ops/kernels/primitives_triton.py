"""The Triton kernels behind the Kernel Primitive factories of
:mod:`.primitives` (ports of ``elementwise_kernel`` and ``reduce_kernel``
in paddle_tpu/ops/pallas/primitives.py).

This module imports Triton; :mod:`.primitives` imports it on the first
launch only, so the package imports on a machine without Triton. The
caller's functor is a ``@triton.jit`` function passed as a
``tl.constexpr`` argument, so Triton compiles one kernel per functor (and
per dtype and arity) and caches it under ``TRITON_CACHE_DIR``.

What bounds both kernels on the H100: bytes (a functor of a few
operations per element). The design reads each element once with
coalesced, masked loads of a power-of-two tile per program; the ragged
tail is masked, never padded in memory.
"""
import triton
import triton.language as tl
from triton.runtime.jit import JITFunction


@triton.jit
def elementwise(out_ptr, a_ptr, b_ptr, c_ptr, d_ptr, n,
                FN: tl.constexpr, NARGS: tl.constexpr,
                BLOCK: tl.constexpr):
    # one tile of BLOCK elements; every operand read in a's dtype, the
    # masked tail loads 0 (the reference's zero pad)
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    a = tl.load(a_ptr + offs, mask=mask, other=0)
    if NARGS == 1:
        y = FN(a)
    elif NARGS == 2:
        b = tl.load(b_ptr + offs, mask=mask, other=0).to(a.dtype)
        y = FN(a, b)
    elif NARGS == 3:
        b = tl.load(b_ptr + offs, mask=mask, other=0).to(a.dtype)
        c = tl.load(c_ptr + offs, mask=mask, other=0).to(a.dtype)
        y = FN(a, b, c)
    else:
        b = tl.load(b_ptr + offs, mask=mask, other=0).to(a.dtype)
        c = tl.load(c_ptr + offs, mask=mask, other=0).to(a.dtype)
        d = tl.load(d_ptr + offs, mask=mask, other=0).to(a.dtype)
        y = FN(a, b, c, d)
    tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=mask)


@triton.jit
def reduce(out_ptr, x_ptr, n, identity, FN: tl.constexpr,
           BLOCK: tl.constexpr):
    # one f32 partial per tile; the masked tail loads the identity
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    x = tl.load(x_ptr + offs, mask=offs < n, other=identity)
    part = FN(x.to(tl.float32))
    tl.store(out_ptr + tl.program_id(0), part.to(tl.float32))


def is_jit_function(fn) -> bool:
    """Whether ``fn`` is a ``@triton.jit`` function."""
    return isinstance(fn, JITFunction)

"""Port of paddle_tpu/ops/pallas/primitives.py, the Kernel Primitive API:
the tile-level building blocks the plain versions of the kernels share,
and the two kernel factories, ``elementwise_kernel`` and
``reduce_kernel``, which turn a caller's functor into a tiled kernel.

The factories are Triton (``primitives_triton``), not CUDA C++: a
factory compiles the caller's functor at run time, which a prebuilt CUDA
library cannot take, and Triton takes a ``@triton.jit`` functor as a
``tl.constexpr`` argument. On CPU tensors each factory runs its plain
version tile by tile; on CUDA tensors it launches its Triton kernel or
raises. ``elementwise_kernel.launches`` and ``reduce_kernel.launches``
count kernel launches.
"""
from __future__ import annotations

import os

import torch

NEG_INF = -1e30


def causal_mask(scores, q_start: int, k_start: int, offset: int = 0):
    """Mask ``scores[..., i, j]`` where global query index i (plus
    ``offset``) is below global key index j. ``offset = kv_len - q_len``
    aligns the diagonal bottom-right, the convention of every attention
    in the package: query i sees keys ``<= i + offset``."""
    bq, bk = scores.shape[-2], scores.shape[-1]
    rows = torch.arange(bq, device=scores.device)[:, None]
    cols = torch.arange(bk, device=scores.device)[None, :]
    keep = (q_start + rows + offset) >= (k_start + cols)
    return torch.where(keep, scores, torch.full_like(scores, NEG_INF))


def f32_mm(a, b):
    """``a @ b`` [M, K] x [K, N] -> [M, N] f32 with the operands in a's
    dtype and f32 accumulation: ``torch.mm(..., out_dtype=float32)`` for a
    bf16 product on the card (f32 straight from the accumulator; a plain
    bf16 matmul would round the result to bf16), the operands upcast to f32
    on the CPU (bf16 x bf16 is exact in f32, so the products are the
    same)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def online_softmax_update(m_prev, l_prev, acc_prev, scores, values):
    """One block step of the streaming softmax, all f32: returns
    ``(m_new, l_new, acc_new)`` from the running max ``m`` [..., q, 1],
    normaliser ``l`` [..., q, 1], weighted accumulator ``acc``
    [..., q, d] and this block's ``scores`` [..., q, k] / ``values``
    [..., k, d]."""
    m_new = torch.maximum(m_prev, scores.amax(-1, keepdim=True))
    p = torch.exp(scores - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(-1, keepdim=True)
    acc_new = acc_prev * alpha + torch.matmul(p, values)
    return m_new, l_new, acc_new


# ---------------------------------------------------------------------------
# kernel factories (one functor -> a complete tiled kernel), in Triton
# ---------------------------------------------------------------------------
def _triton_kernels():
    """The factories' Triton kernels, importing Triton on first use; the
    compiled kernels cache under ``paddle_tpu_torch/_build/triton`` unless
    ``TRITON_CACHE_DIR`` says otherwise."""
    from . import _build
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
    try:
        from . import primitives_triton
        return ((primitives_triton.elementwise, primitives_triton.reduce),
                primitives_triton.is_jit_function)
    except ImportError as e:
        raise RuntimeError(
            "elementwise_kernel / reduce_kernel compile their CUDA kernels "
            "with Triton, which is not installed") from e


def _check_block(block: int) -> int:
    block = int(block)
    if block < 1 or block & (block - 1):
        raise ValueError(f"block must be a power of two (a Triton tile); "
                         f"got {block}")
    return block


def _plain_functor(functor, plain, what: str):
    fn = plain if plain is not None else functor
    if type(fn).__module__.startswith("triton"):
        raise TypeError(f"{what}: a @triton.jit functor runs only on CUDA "
                        "tensors; pass plain= (a torch callable) for the "
                        "CPU")
    return fn


def _launch_check(tensors, functor, is_jit, what: str):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: operands on several devices")
    if not is_jit(functor):
        raise TypeError(f"{what}: on CUDA tensors the functor must be a "
                        f"@triton.jit function; got {type(functor).__name__}")


def elementwise_plain(fn, arrays, block: int):
    """Plain version of the elementwise factory: ``fn`` over flat tiles of
    ``block`` elements (every operand in operand 0's dtype, a zero pad
    past the end), as the reference's interpret mode runs it."""
    x0 = arrays[0]
    n = x0.numel()
    flat = [a.reshape(-1).to(x0.dtype) for a in arrays]
    blk = min(block, n) if n else 1
    pad = (-n) % blk
    if pad:
        flat = [torch.nn.functional.pad(f, (0, pad)) for f in flat]
    out = torch.empty(n + pad, dtype=x0.dtype, device=x0.device)
    for i in range(0, n + pad, blk):
        out[i:i + blk] = fn(*(f[i:i + blk] for f in flat))
    return out[:n].reshape(x0.shape)


def elementwise_kernel(functor, block: int = 4096, plain=None):
    """Build a tiled elementwise kernel from ``functor(*tiles)`` (the
    ElementwiseUnary/Binary/Ternary primitive family; port of the
    reference's factory). Operands share a shape; the result has operand
    0's shape and dtype.

    On CUDA tensors ``functor`` is a ``@triton.jit`` function of 1-4
    tiles and the call launches one Triton kernel; on CPU tensors the
    plain version applies ``plain`` (or ``functor`` itself, when it is a
    torch callable) tile by tile."""
    block = _check_block(block)

    def run(*arrays):
        if not 1 <= len(arrays) <= 4:
            raise ValueError(f"elementwise_kernel takes 1-4 operands; got "
                             f"{len(arrays)}")
        arrays = [torch.as_tensor(a) for a in arrays]
        shape = arrays[0].shape
        if any(a.shape != shape for a in arrays):
            raise ValueError(f"elementwise_kernel operands must share one "
                             f"shape; got {[tuple(a.shape) for a in arrays]}")
        dev = arrays[0].device
        if dev.type == "cpu":
            return elementwise_plain(
                _plain_functor(functor, plain, "elementwise_kernel"),
                arrays, block)
        if dev.type != "cuda":
            raise ValueError(f"elementwise_kernel: no kernel for {dev}")
        (kern, _), is_jit = _triton_kernels()
        _launch_check(arrays, functor, is_jit, "elementwise_kernel")
        flat = [a.contiguous().reshape(-1) for a in arrays]
        out = torch.empty_like(flat[0])
        n = out.numel()
        if n:
            ptrs = flat + [flat[0]] * (4 - len(flat))
            kern[(_cdiv(n, block),)](out, *ptrs, n, FN=functor,
                                          NARGS=len(flat), BLOCK=block)
            elementwise_kernel.launches += 1
        return out.reshape(shape)

    return run


def reduce_plain(fn, identity: float, x, block: int):
    """Plain version of the reduce factory: ``fn`` over f32 tiles of
    ``block`` elements (an ``identity`` pad past the end) gives one f32
    partial a tile, and the partials reduce the same way until one value
    is left. Empty input gives the identity."""
    x = x.reshape(-1)
    if x.numel() == 0:
        return torch.full((), identity, dtype=torch.float32, device=x.device)
    while True:
        n = x.numel()
        pad = (-n) % block
        if pad:
            x = torch.nn.functional.pad(x, (0, pad), value=identity)
        tiles = x.float().reshape(-1, block)
        x = torch.stack([fn(t).float() for t in tiles])
        if x.numel() == 1:
            return x.reshape(())


def reduce_kernel(functor, identity, block: int = 4096, plain=None):
    """Build a tiled full reduction from a tile-reducing ``functor`` and
    its ``identity``, the pad of the ragged tail (the Reduce primitive;
    port of the reference's factory). Returns a 0-dim f32 tensor.

    Each tile reduces to one f32 partial; where the reference combined the
    partials with one more jnp call, the port launches the same kernel on
    the partials until one value is left, so the functor is needed only
    in Triton. On CPU tensors the plain version runs ``plain`` (or
    ``functor``, when it is a torch callable) the same way."""
    block = _check_block(block)
    identity = float(identity)

    def run(x):
        x = torch.as_tensor(x)
        dev = x.device
        if dev.type == "cpu":
            return reduce_plain(_plain_functor(functor, plain, "reduce_kernel"),
                                identity, x, block)
        if dev.type != "cuda":
            raise ValueError(f"reduce_kernel: no kernel for {dev}")
        (_, kern), is_jit = _triton_kernels()
        _launch_check([x], functor, is_jit, "reduce_kernel")
        x = x.contiguous().reshape(-1)
        if x.numel() == 0:
            return torch.full((), identity, dtype=torch.float32, device=dev)
        while True:
            n = x.numel()
            parts = torch.empty(_cdiv(n, block), dtype=torch.float32,
                                device=dev)
            kern[(parts.numel(),)](parts, x, n, identity, FN=functor,
                                   BLOCK=block)
            reduce_kernel.launches += 1
            x = parts
            if n <= block:
                return x.reshape(())

    return run


def _cdiv(n: int, block: int) -> int:
    return -(-n // block)


elementwise_kernel.launches = 0
reduce_kernel.launches = 0

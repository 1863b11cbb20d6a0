"""Mixture of experts on one device — port of paddle_tpu/parallel/moe.py
at ep = 1: the gating (per-token (expert, capacity-slot) assignments) and
its two dispatch schedules.

- ``mode="alltoall"`` (default): sort-based dispatch. Tokens route into
  static ``[E, C]`` per-expert buckets by inverting the assignment map
  (a stable argsort over destination slots and a searchsorted, no
  ``[G, S, E, C]`` one-hot), the experts run on the buckets, and the
  combine gathers each token's capacity slots weighted by its gates. The
  route's backward (:class:`_Route`) mirrors the reference's custom VJP:
  the cotangent gathers back onto the expert outputs, the expert's VJP
  runs on the saved bucket inputs, and the dispatch transpose is a
  scatter-add onto token rows. At ep = 1 the reference's all_to_all is
  the identity, but its wire dtype (``dispatch_dtype``: a float dtype, or
  ``"int8"`` with one absmax step a bucket row) still rounds the buckets
  in both directions and both passes, and so it does here.
- ``mode="einsum"``: the dense GShard form, dispatch and combine as
  einsums against one-hot ``[G, S, E, C]`` masks, kept for A/B.

Ties: ``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does;
every top-k here is built from argmax (take the first maximum, mask it,
take the next), never from ``torch.topk``, whose order among equal
values is not the lowest index on CUDA. The softmax is XLA's, bit for
bit (:func:`softmax_f32`), so equal logits give equal assignments on the
CPU, on the card and in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework import prng
from ..quantization.gpt_quant import quantize_rows

__all__ = ["softmax_f32", "top_k_first", "top2_assign", "switch_assign",
           "top2_gating", "switch_gating", "make_routed_expert",
           "moe_forward", "capacity"]


def capacity(capacity_factor: float, tokens: int, top_k: int,
             experts: int) -> int:
    """Slots per expert: ``max(1, int(cf * tokens * k / E))`` in Python
    floats, the reference's arithmetic."""
    return max(1, int(capacity_factor * tokens * top_k / experts))


class _Softmax(torch.autograd.Function):
    """Forward: XLA's f32 softmax bits; backward: the softmax VJP as
    jax's custom JVP transposes it, ``y * (g - sum(y * g))``."""

    @staticmethod
    def forward(ctx, x):
        u = prng.exp_f32(x - x.amax(-1, keepdim=True))
        total = u[..., 0]
        for i in range(1, u.shape[-1]):
            total = total + u[..., i]
        y = u / total[..., None]
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return y * (g - (y * g).sum(-1, keepdim=True))


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in f32, bit for bit: the
    shifted logits through XLA's exp (:func:`~..framework.prng.exp_f32`),
    summed left to right, then divided; differentiable. No device-to-host
    read."""
    return _Softmax.apply(logits.float())


def top_k_first(x: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, ties to
    the lowest index (``lax.top_k``'s order), from k argmaxes: returns
    ``(values [..., k], indices [..., k] int64)``."""
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        i = torch.argmax(cur, dim=-1)
        vals.append(torch.gather(x, -1, i[..., None])[..., 0])
        idxs.append(i)
        hit = torch.arange(x.shape[-1], device=x.device) == i[..., None]
        cur = torch.where(hit, torch.full_like(cur, -torch.inf), cur)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


# ==========================================================================
# Gating — per-token (expert, capacity-slot) assignments
# ==========================================================================
def _aux(mask1, probs, E: int):
    """The load-balancing loss: mean over groups and experts of (fraction
    routed first) x (mean gate probability), times E^2."""
    return (mask1.mean(1) * probs.mean(1)).mean() * (E * E)


def top2_assign(logits, capacity: int, key=None):
    """GShard top-2 gating in assignment form. logits: [G, S, E] f32.
    Returns ``(experts, slots, gates, valid, aux)``: experts/slots int64
    [G, S, 2], gates f32 [G, S, 2] (renormalised over the kept choices, 0
    where capacity dropped), valid bool [G, S, 2] and the balance loss.
    ``key`` (a :mod:`~..framework.prng` key) draws gumbel noise for the
    second choice: the runner-up is the argmax of logits + noise over the
    other experts (a draw from the renormalised softmax); its gate is
    still its true probability."""
    G, S, E = logits.shape
    probs = softmax_f32(logits)
    gate1 = torch.argmax(probs, dim=-1)
    mask1 = F.one_hot(gate1, E).to(probs.dtype)
    if key is not None:
        noise = prng.gumbel(key, tuple(logits.shape), device=logits.device)
        jittered = torch.where(mask1 > 0, torch.full_like(noise, -torch.inf),
                               logits.float() + noise)
        gate2 = torch.argmax(jittered, dim=-1)
    else:
        gate2 = torch.argmax(probs * (1 - mask1), dim=-1)
    mask2 = F.one_hot(gate2, E).to(probs.dtype)
    aux = _aux(mask1, probs, E)
    # positions within each expert's capacity; the second choice queues
    # behind every kept first choice
    pos1 = torch.cumsum(mask1, dim=1) * mask1 - 1.0
    mask1 = mask1 * (pos1 < capacity)
    pos2 = (torch.cumsum(mask2, dim=1) + mask1.sum(1, keepdim=True)) \
        * mask2 - 1.0
    mask2 = mask2 * (pos2 < capacity)
    g1 = (probs * mask1).sum(-1)
    g2 = (probs * mask2).sum(-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    slot1 = (pos1 * mask1).sum(-1).long()
    slot2 = (pos2 * mask2).sum(-1).long()
    valid1 = mask1.sum(-1) > 0
    valid2 = mask2.sum(-1) > 0
    return (torch.stack([gate1, gate2], -1), torch.stack([slot1, slot2], -1),
            torch.stack([g1 * valid1, g2 * valid2], -1),
            torch.stack([valid1, valid2], -1), aux)


def switch_assign(logits, capacity: int):
    """Switch (top-1) gating in assignment form: :func:`top2_assign`'s
    contract with a trailing k = 1 and the raw gate probability."""
    G, S, E = logits.shape
    probs = softmax_f32(logits)
    gate = torch.argmax(probs, dim=-1)
    mask = F.one_hot(gate, E).to(probs.dtype)
    aux = _aux(mask, probs, E)
    pos = torch.cumsum(mask, dim=1) * mask - 1.0
    mask = mask * (pos < capacity)
    g = (probs * mask).sum(-1)
    slot = (pos * mask).sum(-1).long()
    valid = mask.sum(-1) > 0
    return (gate[..., None], slot[..., None], (g * valid)[..., None],
            valid[..., None], aux)


def _dense_from_assign(experts, slots, gates, valid, E: int, capacity: int):
    """Assignments -> the dense GShard ``(combine, dispatch)`` masks, each
    [G, S, E, C]: the sum over the k choices of gate x one-hot(expert) x
    one-hot(slot) (one-hot products: exact)."""
    w = gates * valid
    combine = 0
    for j in range(experts.shape[-1]):
        eoh = F.one_hot(experts[..., j], E).to(gates.dtype)
        soh = F.one_hot(slots[..., j], capacity).to(gates.dtype)
        combine = combine + w[..., j, None, None] * eoh[..., :, None] \
            * soh[..., None, :]
    return combine, combine > 0


def top2_gating(logits, capacity: int, key=None):
    """GShard top-2 gating, dense form: ``(combine, dispatch, aux)`` with
    the masks [G, S, E, C]."""
    experts, slots, gates, valid, aux = top2_assign(logits, capacity, key)
    combine, dispatch = _dense_from_assign(experts, slots, gates, valid,
                                           logits.shape[-1], capacity)
    return combine, dispatch, aux


def switch_gating(logits, capacity: int):
    """Switch (top-1) gating, dense form."""
    experts, slots, gates, valid, aux = switch_assign(logits, capacity)
    combine, dispatch = _dense_from_assign(experts, slots, gates, valid,
                                           logits.shape[-1], capacity)
    return combine, dispatch, aux


# ==========================================================================
# Sort-based dispatch (mode="alltoall")
# ==========================================================================
def _invert_assign(experts, slots, valid, E: int, cols: int):
    """Invert the (token, choice) -> (expert, slot) map. experts/slots
    [T, k] int, valid [T, k] bool. Returns ``src`` int64 [E * cols]: the
    token row feeding each bucket slot, or T for an empty slot (callers
    pad row T with zeros). A stable argsort and a searchsorted; slots are
    unique per expert, so the map is injective on valid pairs."""
    T, k = experts.shape
    dest = torch.where(valid, experts * cols + slots,
                       torch.full_like(experts, E * cols))
    flat = dest.reshape(T * k)
    order = torch.argsort(flat, stable=True)
    sorted_dest = flat[order]
    want = torch.arange(E * cols, device=flat.device)
    pos = torch.searchsorted(sorted_dest, want).clamp(0, T * k - 1)
    hit = sorted_dest[pos] == want
    return torch.where(hit, (order // k)[pos], torch.full_like(pos, T))


def _wire(dispatch_dtype):
    """The round trip of the ep all_to_all's wire dtype at ep = 1 (the
    exchange itself is the identity): a float dtype casts there and back;
    ``"int8"`` quantizes each bucket row against its absmax and
    dequantizes; None leaves the buckets as they are."""
    if dispatch_dtype is None:
        return lambda b: b
    if isinstance(dispatch_dtype, str):
        if dispatch_dtype != "int8":
            raise ValueError(f"dispatch_dtype {dispatch_dtype!r} unknown: "
                             "a torch float dtype, 'int8' or None")

        def int8(b):
            q, step = quantize_rows(b)
            return (q.float() * step[..., None]).to(b.dtype)
        return int8
    return lambda b: b.to(dispatch_dtype).to(b.dtype)


class _Route(torch.autograd.Function):
    """The routed expert with the reference's custom VJP: the backward
    saves the buckets and the expert outputs, gathers the cotangent back
    onto the outputs, runs the expert's VJP on the saved inputs (a
    recompute of the expert forward, as ``jax.vjp`` in the reference's
    backward) and scatter-adds the dispatch transpose onto token rows;
    the wire round trip applies in both directions of both passes."""

    @staticmethod
    def forward(ctx, spec, x, gates, experts, slots, valid, *leaves):
        expert_fn, E, cols, wire, names = spec
        T, M = x.shape
        src = _invert_assign(experts, slots, valid, E, cols)
        x_pad = torch.cat([x, x.new_zeros((1, M))])
        expert_in = wire(x_pad[src].reshape(E, cols, M))
        y = wire(expert_fn(dict(zip(names, leaves)), expert_in))
        flat = y.reshape(E * cols, y.shape[-1])
        idx = torch.where(valid, experts * cols + slots,
                          torch.zeros_like(experts))
        w = (gates * valid).float()
        out = (w[..., None] * flat[idx].float()).sum(1)
        ctx.spec = spec
        ctx.T = T
        ctx.save_for_backward(gates, valid, idx, src, expert_in, flat,
                              *leaves)
        return out

    @staticmethod
    def backward(ctx, g_out):
        expert_fn, E, cols, wire, names = ctx.spec
        gates, valid, idx, src, expert_in, flat, *leaves = ctx.saved_tensors
        T, M = ctx.T, expert_in.shape[-1]
        g_out = g_out.float()
        picked = flat[idx].float()                          # [T, k, M']
        d_gates = ((g_out[:, None, :] * picked).sum(-1) * valid).to(
            gates.dtype)
        w = (gates * valid).float()
        d_flat = torch.zeros(flat.shape, dtype=torch.float32,
                             device=flat.device).index_add_(
            0, idx.reshape(-1),
            (w[..., None] * g_out[:, None, :]).reshape(-1, flat.shape[-1]))
        d_y = wire(d_flat.reshape(E, cols, -1).to(flat.dtype))
        with torch.enable_grad():
            ps = [t.detach().requires_grad_() for t in leaves]
            ein = expert_in.detach().requires_grad_()
            y = expert_fn(dict(zip(names, ps)), ein)
            grads = torch.autograd.grad(y, ps + [ein], d_y.to(y.dtype))
        d_in = wire(grads[-1])
        d_xpad = torch.zeros((T + 1, M), dtype=torch.float32,
                             device=flat.device).index_add_(
            0, src, d_in.reshape(E * cols, M).float())
        return (None, d_xpad[:T].to(expert_in.dtype), d_gates, None, None,
                None, *grads[:-1])


def make_routed_expert(expert_fn, E: int, cols: int, ep_axis=None,
                       dispatch_dtype=None):
    """The sort-based routed expert: ``route(x, gates, experts, slots,
    valid, expert_params) -> out`` with x [T, M] tokens, gates [T, k] f32,
    experts/slots [T, k] int, valid [T, k] bool and ``expert_fn(params,
    buckets [E, cols, M])``; out [T, M'] f32, each token's gate-weighted
    sum of its capacity slots. One device: ``ep_axis`` must be None."""
    if ep_axis is not None:
        raise NotImplementedError(
            f"ep_axis={ep_axis!r}: the port routes experts on one device; "
            "the ep all_to_all belongs to the multi-device slice")
    wire = _wire(dispatch_dtype)

    def route(x, gates, experts, slots, valid, expert_params):
        names = tuple(expert_params)
        spec = (expert_fn, E, cols, wire, names)
        return _Route.apply(spec, x, gates, experts, slots, valid,
                            *(expert_params[n] for n in names))

    return route


# ==========================================================================
# moe_forward — the shared entry point (both modes)
# ==========================================================================
def moe_forward(x, gate_w, expert_fn, expert_params, capacity_factor=1.25,
                top_k=2, mode: str = "alltoall", dispatch_dtype=None,
                key=None, ep_axis=None):
    """x: [G, S, M]; gate_w: [M, E]; the expert params carry a leading E
    dim and ``expert_fn(params_of_one_expert, tokens [G, C, M])`` runs one
    expert (it is applied per expert). Returns ``(out [G, S, M'] in x's
    dtype, aux)``. ``key`` jitters the top-2 second choice."""
    if mode not in ("alltoall", "einsum"):
        raise ValueError(f"unknown moe dispatch mode {mode!r}")
    G, S, M = x.shape
    E = gate_w.shape[1]
    C = capacity(capacity_factor, S, top_k, E)
    logits = torch.einsum("gsm,me->gse", x.float(), gate_w.float())
    if top_k == 1:
        experts, slots, gates, valid, aux = switch_assign(logits, C)
    else:
        experts, slots, gates, valid, aux = top2_assign(logits, C, key)

    def per_expert(params, buckets):
        # [E, G, C, M] -> expert_fn on each expert's [G, C, M]
        return torch.stack([expert_fn({n: t[e] for n, t in params.items()},
                                      buckets[e]) for e in range(E)])

    if mode == "einsum":
        combine, dispatch = _dense_from_assign(experts, slots, gates,
                                               valid, E, C)
        expert_in = torch.einsum("gsec,gsm->egcm", dispatch.to(x.dtype), x)
        expert_out = per_expert(expert_params, expert_in)
        out = torch.einsum("gsec,egcm->gsm", combine,
                           expert_out.float())
        return out.to(x.dtype), aux

    def bucket_fn(params, buckets):
        y = per_expert(params, buckets.reshape(E, G, C, M))
        return y.reshape(E, G * C, y.shape[-1])

    route = make_routed_expert(bucket_fn, E, G * C, ep_axis=ep_axis,
                               dispatch_dtype=dispatch_dtype)
    goff = torch.arange(G, device=x.device)[:, None, None]
    k = experts.shape[-1]
    out = route(x.reshape(G * S, M), gates.reshape(G * S, k),
                experts.reshape(G * S, k),
                (slots + goff * C).reshape(G * S, k),
                valid.reshape(G * S, k), expert_params)
    return out.reshape(G, S, -1).to(x.dtype), aux

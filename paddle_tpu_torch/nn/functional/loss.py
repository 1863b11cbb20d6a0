"""Loss functionals: port of paddle_tpu/nn/functional/loss.py (reference:
python/paddle/nn/functional/loss.py; phi cross_entropy / bce kernels).
Labels are int32 as the reference holds them and widen to int64 only for
the torch gather that picks the target's log-probability."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...tensor import def_op


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def _pick(logp, lab, axis):
    """logp's entry at each label along ``axis`` (the label squeezed)."""
    return torch.take_along_dim(logp, lab.long().unsqueeze(axis),
                                dim=axis).squeeze(axis)


@def_op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    axis = int(axis) % input.dim()
    n_classes = input.shape[axis]
    logp = torch.log_softmax(input, axis) if use_softmax \
        else torch.log(torch.clamp_min(input, 1e-30))

    if soft_label or (label.is_floating_point()
                      and label.shape == input.shape):
        soft = label.to(logp.dtype)
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -torch.sum(soft * logp, axis)
        if weight is not None:
            wshape = (1,) * axis + (-1,) + (1,) * (input.dim() - axis - 1)
            loss = loss * torch.sum(soft * weight.reshape(wshape), axis)
        return _reduce(loss, reduction)

    lab = label
    if lab.dim() == input.dim() and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = _pick(logp, safe, axis)
    if label_smoothing > 0:
        loss = -(1 - label_smoothing) * picked \
            - label_smoothing * torch.mean(logp, axis)
    else:
        loss = -picked
    w = None
    if weight is not None:
        w = weight[safe.long()]
        loss = loss * w
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = (torch.sum(w * valid) if w is not None
                 else torch.sum(valid.to(loss.dtype)))
        return torch.sum(loss) / torch.clamp_min(denom, 1e-12)
    return _reduce(loss, reduction)


@def_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    axis = int(axis) % logits.dim()
    logp = torch.log_softmax(logits, axis)
    if soft_label:
        loss = -torch.sum(label * logp, axis, keepdim=True)
    else:
        lab = label
        if lab.dim() == logits.dim() and lab.shape[axis] == 1:
            lab = lab.squeeze(axis)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, torch.zeros_like(lab))
        loss = torch.where(valid.unsqueeze(axis),
                           -_pick(logp, safe, axis).unsqueeze(axis),
                           torch.zeros((), dtype=logp.dtype,
                                       device=logp.device))
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@def_op("mse_loss")
def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


@def_op("l1_loss")
def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


@def_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = torch.abs(input - label)
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


@def_op("huber_loss")
def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    d = torch.abs(input - label)
    return _reduce(torch.where(d <= delta, 0.5 * d * d,
                               delta * (d - 0.5 * delta)), reduction)


@def_op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    loss = -_pick(input, safe, 1)
    w = weight[safe.long()] if weight is not None else torch.ones_like(loss)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    loss = torch.where(valid, loss * w, zero)
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp_min(
            torch.sum(torch.where(valid, w, zero)), 1e-12)
    return _reduce(loss, reduction)


@def_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp_min(input, eps))
             + (1 - label) * torch.log(torch.clamp_min(1 - input, eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@def_op("binary_cross_entropy_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    softplus_neg_abs = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1 - label) * logit + log_w * (
            softplus_neg_abs + torch.clamp_min(-logit, 0))
    else:
        loss = torch.clamp_min(logit, 0) - logit * label + softplus_neg_abs
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@def_op("kl_div")
def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
        loss = torch.where(label > 0, loss, torch.zeros_like(loss))
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@def_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0),
                   reduction)


@def_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0)),
                   reduction)


@def_op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = torch.sum(input1 * input2, -1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0)), reduction)


@def_op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-06, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.sum(torch.abs(a - b) ** p + epsilon, -1) ** (1.0 / p)
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0), reduction)


@def_op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@def_op("square_error_cost")
def square_error_cost(input, label):
    return torch.square(input - label)


@def_op("log_loss")
def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


@def_op("dice_loss")
def dice_loss(input, label, epsilon=1e-05, name=None):
    oh = TF.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * oh, dims)
    union = torch.sum(input + oh, dims)
    return torch.mean(1 - 2 * inter / (union + epsilon))


@def_op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(TF.softplus(-label.to(input.dtype) * input), reduction)


@def_op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    lab = label.to(input.dtype)
    loss = -(lab * TF.logsigmoid(input) + (1 - lab) * TF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(torch.mean(loss, -1), reduction)


@def_op("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    n, c = input.shape
    correct = _pick(input, label, 1).unsqueeze(1)
    diff = torch.clamp_min(margin - correct + input, 0)
    if p != 1:
        diff = diff ** p
    if weight is not None:
        diff = diff * weight[label.long()][:, None]
    mask = TF.one_hot(label.long(), c).to(input.dtype)
    return _reduce(torch.sum(diff * (1 - mask), 1) / c, reduction)


@def_op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp_min(variance, epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(label - input) / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


@def_op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label) - label
                    + 0.5 * torch.log(2 * math.pi * label))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


@def_op("ctc_loss_op")
def _ctc(log_probs, labels, input_lengths, label_lengths, blank):
    """Per-sequence CTC negative log-likelihood over [T, B, C] scores,
    normalised first as the reference's optax.ctc_loss does (warpctc's
    softmax in paddle)."""
    logp = torch.log_softmax(log_probs.float(), -1)
    return TF.ctc_loss(logp, labels.long(), input_lengths.long(),
                       label_lengths.long(), blank=blank, reduction="none")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    loss = _ctc(log_probs, labels, input_lengths, label_lengths, blank)
    from ...ops import math as _m
    if reduction == "mean":
        return _m.mean(_m.divide(loss, label_lengths.astype("float32")))
    if reduction == "sum":
        return _m.sum(loss)
    return loss


def _l2_distance(a, b):
    return torch.sqrt(torch.sum(torch.square(a - b), -1) + 1e-12)


@def_op("triplet_margin_with_distance_loss")
def _triplet_distance(input, positive, negative, margin, swap, reduction):
    d_pos = _l2_distance(input, positive)
    d_neg = _l2_distance(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, _l2_distance(positive, negative))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """max(d(a, p) - d(a, n) + margin, 0); ``d`` the L2 distance, or
    ``distance_function`` applied to the Tensors."""
    if distance_function is None:
        return _triplet_distance(input, positive, negative, margin, swap,
                                 reduction)
    from ...ops import math as _m
    from .activation import relu
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = _m.minimum(d_neg, distance_function(positive, negative))
    loss = relu(d_pos - d_neg + margin)
    if reduction == "mean":
        return _m.mean(loss)
    if reduction == "sum":
        return _m.sum(loss)
    return loss


@def_op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree
    (reference: nn/functional/loss.py hsigmoid_loss; custom trees through
    path_table/path_code are not supported)."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError("custom-tree hsigmoid not supported")
    code_len = int(math.ceil(math.log2(num_classes))) + 1
    # node walk on the implicit heap: leaf = label + num_classes, parent
    # = cur // 2, stop at the root (cur == 1); steps past the root add 0
    loss = torch.zeros(input.shape[0], dtype=input.dtype,
                       device=input.device)
    cur = label.long() + num_classes
    for _ in range(code_len):
        active = (cur > 1).to(input.dtype)
        bit = (cur % 2).to(input.dtype)
        parent = cur // 2
        node = torch.clamp(parent - 1, 0, weight.shape[0] - 1)
        logit = torch.sum(weight[node] * input, -1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[node]
        step = -(bit * TF.logsigmoid(logit)
                 + (1 - bit) * TF.logsigmoid(-logit))
        loss = loss + active * step
        cur = parent
    return loss[:, None]


@def_op("rnnt_loss")
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-T transducer loss by the forward algorithm in log space
    (reference: warprnnt; the reference's lax.scan dynamic program as
    loops over t and u, vectorised over the batch) on [B, T, U+1, V]
    scores."""
    if fastemit_lambda:
        raise NotImplementedError(
            "FastEmit regularization is not implemented; pass "
            "fastemit_lambda=0")
    logp = torch.log_softmax(input, -1)
    B, T, U1, _ = logp.shape
    blank_lp = logp[..., blank]                                # [B, T, U1]
    lab = label.long()
    lab_pad = torch.cat([lab, lab.new_zeros(B, 1)], 1)[:, :U1]
    emit_lp = torch.take_along_dim(
        logp, lab_pad[:, None, :, None], dim=-1)[..., 0]       # [B, T, U1]
    # t = 0: emissions along u only
    row = [logp.new_zeros(B)]
    for u in range(1, U1):
        row.append(row[-1] + emit_lp[:, 0, u - 1])
    hist = [torch.stack(row, 1)]
    for t in range(1, T):
        from_blank = hist[-1] + blank_lp[:, t - 1]
        row = [from_blank[:, 0]]
        for u in range(1, U1):
            row.append(torch.logaddexp(from_blank[:, u],
                                       row[-1] + emit_lp[:, t, u - 1]))
        hist.append(torch.stack(row, 1))
    full_hist = torch.stack(hist, 0)                            # [T, B, U1]
    t_idx = torch.clamp(input_lengths.long() - 1, 0, T - 1)
    u_idx = torch.clamp(label_lengths.long(), 0, U1 - 1)
    b_idx = torch.arange(B, device=logp.device)
    nll = -(full_hist[t_idx, b_idx, u_idx] + blank_lp[b_idx, t_idx, u_idx])
    return _reduce(nll, reduction)

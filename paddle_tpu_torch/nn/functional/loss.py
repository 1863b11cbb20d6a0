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

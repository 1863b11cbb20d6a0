"""incubate.nn fused layers: port of paddle_tpu/incubate/nn.

So far :class:`FusedBiasDropoutResidualLayerNorm`, the caller of the fused
bias-dropout-residual LayerNorm kernel. Its siblings in the reference
(``FusedMultiHeadAttention``, ``FusedFeedForward``, ... and
``incubate.nn.functional``) stand on the eager framework surface and come
with its port.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from ...framework import prng, random
from ...ops.kernels.fused_residual_ln import fused_bias_dropout_residual_ln


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """y = LayerNorm(residual + dropout(x + bias)) in one kernel
    (reference: incubate/nn/layer/fused_transformer.py
    FusedBiasDropoutResidualLayerNorm).

    The parameters keep the reference's names (``linear_bias``,
    ``ln_scale``, ``ln_bias``; f32, initialised to 0, 1 and 0), so state
    dicts carry across. In training every forward draws a fresh dropout
    seed, ``bits(next_key())`` of the global stream that
    ``paddle_tpu_torch.seed`` resets, as the reference does; in eval the
    seed is 0 and no element drops."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, name=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim = int(embed_dim)
        self.dropout_rate = float(dropout_rate)
        self._epsilon = float(epsilon)
        f32 = dict(dtype=torch.float32, device=dev)
        self.linear_bias = nn.Parameter(torch.zeros(self.embed_dim, **f32))
        self.ln_scale = nn.Parameter(torch.ones(self.embed_dim, **f32))
        self.ln_bias = nn.Parameter(torch.zeros(self.embed_dim, **f32))

    def forward(self, x, residual):
        lead, d = x.shape[:-1], x.shape[-1]
        seed = prng._bits_host(random.next_key()) if self.training else 0
        out = fused_bias_dropout_residual_ln(
            x.reshape(-1, d), self.linear_bias, residual.reshape(-1, d),
            self.ln_scale, self.ln_bias, p=self.dropout_rate,
            eps=self._epsilon, training=self.training, seed=seed)
        return out.reshape(*lead, d)

    @torch.no_grad()
    def state_from_numpy(self, state: dict):
        """Copy numpy arrays keyed by parameter name (the reference layer's
        ``state_dict`` as numpy) into this layer's parameters."""
        own = dict(self.named_parameters())
        if set(state) != set(own):
            raise ValueError(f"state keys {sorted(state)} differ from the "
                             f"layer's {sorted(own)}")
        for name, value in state.items():
            value = np.asarray(value, np.float32)
            if value.shape != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {value.shape}, expected "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(torch.from_numpy(value))
        return self

    def extra_repr(self):
        return f"embed_dim={self.embed_dim}, p={self.dropout_rate}"


__all__ = ["FusedBiasDropoutResidualLayerNorm"]

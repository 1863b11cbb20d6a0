"""Model-parallel layers at degree 1: port of the layer half of
paddle_tpu/distributed/fleet/meta_parallel/parallel_layers.py (reference:
``fleet/layers/mpu/mp_layers.py`` — VocabParallelEmbedding,
ColumnParallelLinear, RowParallelLinear, ParallelCrossEntropy).

The port runs on one device, so each layer is its plain counterpart with
the reference's parameters ([in, out] weights, XavierNormal, zero bias)
and raises on a model-parallel group of more than one rank, the rule
``models.gpt.GPTConfig`` applies to a mesh degree above 1. ``PipelineLayer``
and its descriptors wait for the multi-device slice.
"""
from __future__ import annotations

from ....nn import functional as F
from ....nn.initializer import XavierNormal
from ....nn.layer import Layer


def _check_degree(mp_group):
    n = getattr(mp_group, "nranks", 1) if mp_group is not None else 1
    if n != 1:
        raise NotImplementedError(
            f"model-parallel degree {n}: the port runs on one device; "
            "multi-device parallelism belongs to later slices")


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        _check_degree(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierNormal())
        self.weight.is_distributed = True

    def forward(self, x):
        return F.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        _check_degree(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal())
        self.weight.is_distributed = True
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)
            self.bias.is_distributed = True

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        _check_degree(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal())
        self.weight.is_distributed = True
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)

    def forward(self, x):
        out = F.linear(x, self.weight, None)
        return out + self.bias if self.bias is not None else out


class ParallelCrossEntropy(Layer):
    """Softmax cross entropy over the (unsharded) vocab logits."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        _check_degree(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.softmax_with_cross_entropy(input, label,
                                            ignore_index=self.ignore_index)

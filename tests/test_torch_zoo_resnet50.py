"""The port's bottleneck ResNet against the reference's with the same
weights: logits within 1e-4, gradients within 1e-4 of their scale, three
Momentum steps within 1e-5, and the train-mode BatchNorm statistics of the
bottleneck block (tests/test_torch_zoo.py holds ResNet-18 and the
surface)."""
import numpy as np

import pytest

from test_torch_zoo import X64, Y
from torch_eager_ref import NumpyMomentum, P, T, train_parity, twins
from torch_eager_ref import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def test_bottleneck_resnet_trains_as_the_reference(monkeypatch):
    """``ResNet(BottleneckBlock, ...)`` cut to the first block of each stage:
    ResNet-50's blocks (1x1, 3x3, 1x1 with the 4x expansion and the projection
    shortcuts) in its four stages, BatchNorm in eval mode (weights He-scaled by
    0.5: nothing renormalizes the residual sums). In train mode at batch 2 the
    reference's own gradients move by 9 % when the input moves by 1e-6 (the
    port's by 3e-4; each block alone agrees within 5e-7, measured): a
    network-level comparison there measures the reference's rounding, so the
    train-mode statistics are held on the block below. The reference runs
    through its ``jit.to_static`` and the Momentum steps in numpy on both (its
    eager ops and optimizer compile one by one)."""
    from paddle_tpu.models.resnet import BottleneckBlock as RB, ResNet as RR
    from paddle_tpu_torch.models.resnet import (BottleneckBlock as TB,
                                                ResNet as TR)
    def cut(M, net):
        for i in range(1, 5):
            stage = getattr(net, f"layer{i}")
            setattr(net, f"layer{i}", M.nn.Sequential(stage[0]))
        return net
    ref, port = twins(
        lambda: P.jit.to_static(cut(P, RR(RB, 18, num_classes=10))),
        lambda: cut(T, TR(TB, 18, num_classes=10)), monkeypatch, gain=0.5)
    losses = train_parity(ref, port, X64, Y, lr=0.01, mode="eval",
                          optimizer=NumpyMomentum)
    assert losses[-1] < losses[0]


def test_bottleneck_block_trains_as_the_reference(monkeypatch):
    """One downsampling BottleneckBlock in train mode: output, gradients,
    three Momentum steps and its BatchNorm running statistics."""
    from paddle_tpu.models import resnet as R
    from paddle_tpu_torch.models import resnet as TRN

    def block(M, nn):
        down = nn.Sequential(nn.Conv2D(32, 64, 1, stride=2,
                                       bias_attr=False), nn.BatchNorm2D(64))
        return M.BottleneckBlock(32, 16, stride=2, downsample=down)
    ref, port = twins(lambda: block(R, P.nn), lambda: block(TRN, T.nn),
                      monkeypatch)
    x = np.random.default_rng(4).standard_normal((2, 32, 8, 8)).astype(
        np.float32)
    train_parity(ref, port, x, lr=0.01)

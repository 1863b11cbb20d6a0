"""The port's ResNet (``paddle_tpu_torch.models.resnet``) against the
reference's: ResNet-18 and the bottleneck ResNet-50 with the same weights —
logits within 1e-4, gradients within 1e-4 of their scale, three Momentum
steps (PaddleClas's ResNet50.yaml: lr 0.1, momentum 0.9, L2Decay 1e-4)
within 1e-5 with the BatchNorm statistics — and the zoo's surface. The
parity steps take lr 0.01: at lr 0.1 and batch 2 the third step's loss
falls to ~0.04 and float rounding moves it by 0.4 % (measured);
tests/test_torch_zoo_resnet50.py holds the bottleneck ResNet."""
import numpy as np
import pytest

from torch_eager_ref import P, T, train_parity, twins
from torch_eager_ref import few_threads  # noqa: F401

X64 = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(
    np.float32)
Y = np.array([3, 7])

pytestmark = pytest.mark.usefixtures("few_threads")


def test_resnet18_trains_as_the_reference(monkeypatch):
    """2x3x64x64: at 32x32 the last stage's BatchNorm normalizes two
    values a channel, and rounding decides their signs. The reference
    runs through its ``jit.to_static`` (its eager ops compile one by
    one), BatchNorm statistics updated inside its program."""
    ref, port = twins(
        lambda: P.jit.to_static(P.vision.models.resnet18(num_classes=10)),
        lambda: T.vision.models.resnet18(num_classes=10), monkeypatch)
    losses = train_parity(ref, port, X64, Y, lr=0.01)
    assert losses[-1] < losses[0]


def test_pretrained_raises_and_the_zoo_surface():
    for ctor in (T.vision.models.resnet50, T.vision.models.mobilenet_v2,
                 T.vision.models.resnext50_32x4d):
        with pytest.raises(ValueError):
            ctor(pretrained=True)
    names = [n for n in dir(P.vision.models) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(T.vision.models, n)]
    assert not missing, missing
    for n in ("ResNet", "resnet18", "resnet50", "Bert", "BertConfig"):
        assert hasattr(T.models, n)

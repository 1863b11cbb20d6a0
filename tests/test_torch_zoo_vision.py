"""The vision zoo of the port against the reference's, one constructor of
each family at the input tests/test_vision_zoo.py gives it: AlexNet, VGG,
MobileNetV1 and ShuffleNetV2 (tests/test_torch_zoo_vision_{b,c,d,e}.py
hold the rest). ``num_classes=0`` keeps AlexNet's and VGG's
4096-wide classifiers (57M and 120M weights) out; their loss is the mean
square of the features."""
import numpy as np
import pytest

from torch_eager_ref import (NumpyMomentum, P, T, assert_close, train_parity,
                             twins)
from torch_eager_ref import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def zoo_parity(name, kw, shape, monkeypatch):
    """Seeded weights in both packages (He-scaled by 0.5); the reference runs
    through its ``jit.to_static`` (one XLA program and its VJP: its eager ops
    compile one by one, 30-60 s a model); in eval mode the logits within 1e-4,
    the gradients within 1e-4 of their scale and three Momentum steps (in
    numpy, on both) within 1e-5. (Train-mode steps of BatchNorm networks are
    not compared: the reference's BatchNorm gradients move by 9 % when its
    input moves by 1e-6, measured on the bottleneck ResNet;
    tests/test_torch_zoo*.py hold the train-mode statistics on ResNet-18 and
    the bottleneck block.)"""
    ref, port = twins(lambda: P.jit.to_static(
                          getattr(P.vision.models, name)(**kw)),
                      lambda: getattr(T.vision.models, name)(**kw),
                      monkeypatch, gain=0.5)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    label = None if kw.get("num_classes") == 0 else \
        np.arange(shape[0]) % kw["num_classes"]
    losses = train_parity(ref, port, x, label, lr=0.01, mode="eval",
                          optimizer=NumpyMomentum)
    assert losses[-1] < losses[0]


def logits_parity(name, kw, shape, monkeypatch):
    """The eval-mode logits of the same seeded weights within 1e-4 (for
    the two families whose reference program takes 25-45 s to compile
    with its VJP: their layers' gradients are held in the other
    families)."""
    ref, port = twins(lambda: P.jit.to_static(
                          getattr(P.vision.models, name)(**kw)),
                      lambda: getattr(T.vision.models, name)(**kw),
                      monkeypatch, gain=0.5)
    ref.eval()
    port.eval()
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    with P.no_grad():
        r = ref(P.to_tensor(x))
    with T.no_grad():
        t = port(T.to_tensor(x))
    assert t.shape == r.shape == [shape[0], kw["num_classes"]]
    assert_close(r, t, 1e-4, name)


CASES = [
    ("alexnet", dict(num_classes=0), (2, 3, 64, 64)),
    ("vgg11", dict(batch_norm=True, num_classes=0), (2, 3, 64, 64)),
    ("mobilenet_v1", dict(num_classes=10), (2, 3, 64, 64)),
    ("shufflenet_v2_x0_25", dict(num_classes=10), (2, 3, 64, 64)),
]


@pytest.mark.parametrize("name,kw,shape", CASES, ids=[c[0] for c in CASES])
def test_zoo_family_trains_as_the_reference(name, kw, shape, monkeypatch):
    zoo_parity(name, kw, shape, monkeypatch)

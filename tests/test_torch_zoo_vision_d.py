"""The vision zoo of the port against the reference's (continued):
GoogLeNet (its main logits; the aux heads' shapes) at the input
tests/test_vision_zoo.py gives it."""
import numpy as np
import pytest

from test_torch_zoo_vision import zoo_parity
from torch_eager_ref import T, zero_init
from torch_eager_ref import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def test_googlenet_trains_as_the_reference(monkeypatch):
    zoo_parity("googlenet", dict(num_classes=10), (1, 3, 64, 64),
               monkeypatch)


def test_googlenet_aux_heads(monkeypatch):
    zero_init(monkeypatch)
    m = T.vision.models.googlenet(num_classes=7)
    m.eval()
    x = T.to_tensor(np.random.default_rng(0).standard_normal(
        (1, 3, 64, 64)).astype(np.float32))
    out, aux1, aux2 = m(x)
    assert out.shape == aux1.shape == aux2.shape == [1, 7]

"""The vision zoo of the port against the reference's (continued):
SqueezeNet, and DenseNet's logits, at the input tests/test_vision_zoo.py
gives them."""
import pytest

from test_torch_zoo_vision import logits_parity, zoo_parity
from torch_eager_ref import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def test_squeezenet_trains_as_the_reference(monkeypatch):
    zoo_parity("squeezenet1_1", dict(num_classes=10), (2, 3, 64, 64),
               monkeypatch)


def test_densenet_logits_equal_the_reference(monkeypatch):
    logits_parity("densenet121", dict(num_classes=10), (2, 3, 64, 64),
                  monkeypatch)

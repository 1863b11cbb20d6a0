"""The vision zoo of the port against the reference's (continued):
InceptionV3's logits at the 1x3x299x299 input tests/test_vision_zoo.py
gives it."""
import pytest

from test_torch_zoo_vision import logits_parity
from torch_eager_ref import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def test_inception_v3_logits_equal_the_reference(monkeypatch):
    logits_parity("inception_v3", dict(num_classes=10), (1, 3, 299, 299),
                  monkeypatch)

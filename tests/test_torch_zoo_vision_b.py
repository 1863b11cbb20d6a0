"""The vision zoo of the port against the reference's (continued):
MobileNetV2 and V3 at the input tests/test_vision_zoo.py gives them."""
import pytest

from test_torch_zoo_vision import zoo_parity
from torch_eager_ref import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CASES = [
    ("mobilenet_v2", dict(num_classes=10), (2, 3, 64, 64)),
    ("mobilenet_v3_small", dict(num_classes=10), (2, 3, 64, 64)),
]


@pytest.mark.parametrize("name,kw,shape", CASES, ids=[c[0] for c in CASES])
def test_zoo_family_trains_as_the_reference(name, kw, shape, monkeypatch):
    zoo_parity(name, kw, shape, monkeypatch)

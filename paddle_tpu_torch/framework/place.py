"""Device places: port of paddle_tpu/framework/place.py.

A Place is a hashable handle that resolves to a ``torch.device``. The
eager surface (``to_tensor``, the creation and random ops, a Layer's
parameters) puts new tensors on the current place. It is the CUDA card
unless :func:`set_device` chose another, and with no card the default
raises instead of carrying on on the CPU: ``set_device("cpu")`` runs the
eager surface there, as the tests do.
"""
from __future__ import annotations

import torch


class Place:
    device_type: str = "undefined"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        raise RuntimeError(f"no torch device for {self!r}")


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and none "
                "is available; call set_device('cpu') to run on the CPU")
        return torch.device("cuda", self.device_id)


class CustomPlace(Place):
    """Plugin-device place (reference: custom device via device_ext.h)."""

    def __init__(self, device_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.device_type = device_type


# the reference's TPU place names the accelerator; here that is the card
TPUPlace = CUDAPlace

_current_place: Place | None = None


def resolve_place(device) -> Place:
    """Parse a device string (or torch.device / Place) to a Place without
    touching global state."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    if ":" in device:
        kind, idx = device.split(":", 1)
        idx = int(idx)
    else:
        kind, idx = device, 0
    if kind in ("gpu", "cuda", "tpu"):
        return CUDAPlace(idx)
    if kind == "cpu":
        return CPUPlace(idx)
    return CustomPlace(kind, idx)


def set_device(device) -> Place:
    """paddle.set_device: ``"gpu"``/``"cuda"`` (``"tpu"`` names the
    accelerator too) or ``"cpu"``. Asking for the card without one
    raises."""
    global _current_place
    place = resolve_place(device)
    place.torch_device()
    _current_place = place
    return place


def get_current_place() -> Place:
    """The current place: the card unless :func:`set_device` chose
    another."""
    return _current_place if _current_place is not None else CUDAPlace(0)


def get_device() -> str:
    p = get_current_place()
    return f"{p.device_type}:{p.device_id}"


def current_device() -> torch.device:
    """The torch device new tensors go to; raises without a card unless
    the CPU was chosen."""
    return get_current_place().torch_device()


def place_device(place=None) -> torch.device:
    """The torch device of a ``place`` argument (None: the current one)."""
    if place is None:
        return current_device()
    return resolve_place(place).torch_device()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()

"""paddle.save / paddle.load: port of paddle_tpu/framework/io_state.py
(reference: python/paddle/framework/io.py).

An object checkpoint is a pickle whose Tensor leaves are numpy arrays (a
bf16 tensor travels as its uint16 bits), in an envelope with a format
version; ``save`` writes it atomically (temp file, fsync, rename). It holds
Tensors, Layer and optimizer ``state_dict``s and any nesting of dicts,
lists and tuples of them. ``load`` puts every Tensor on the place it is
given, the current place by default (the card unless ``set_device`` chose
the CPU), so loading onto the CPU or the card is the caller's choice.
"""
from __future__ import annotations

import os
import pickle
import uuid

import numpy as np
import torch

from ..tensor import Parameter, Tensor, _val
from .place import place_device

CKPT_FORMAT_VERSION = 1
_CKPT_KEY = "__paddle_tpu_torch_ckpt__"


class _TensorPayload:
    def __init__(self, t: Tensor):
        v = _val(t).detach().cpu()
        self.dtype = str(v.dtype).replace("torch.", "")
        self.array = (v.view(torch.int16) if v.dtype == torch.bfloat16
                      else v).numpy()
        self.name = t.name
        self.parameter = isinstance(t, Parameter)
        self.stop_gradient = t.stop_gradient

    def to_tensor(self, device, return_numpy):
        v = torch.from_numpy(np.array(self.array))
        if self.dtype == "bfloat16":
            v = v.view(torch.bfloat16)
        if return_numpy:
            return v.float().numpy() if self.dtype == "bfloat16" \
                else v.numpy()
        v = v.to(device)
        t = Parameter(v, not self.stop_gradient, self.name) \
            if self.parameter else Tensor(v, self.stop_gradient, self.name)
        return t


def _pack(obj):
    if isinstance(obj, Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _pack(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        try:
            return type(obj)(packed)
        except TypeError:   # namedtuple
            return type(obj)(*packed)
    return obj


def _unpack(obj, device, return_numpy):
    if isinstance(obj, _TensorPayload):
        return obj.to_tensor(device, return_numpy)
    if isinstance(obj, dict):
        return type(obj)((k, _unpack(v, device, return_numpy))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        out = [_unpack(v, device, return_numpy) for v in obj]
        try:
            return type(obj)(out)
        except TypeError:
            return type(obj)(*out)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (Tensor leaves -> numpy) atomically: a crash mid-save
    leaves the previous file whole."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    envelope = {_CKPT_KEY: CKPT_FORMAT_VERSION, "payload": _pack(obj)}
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(envelope, f, protocol=protocol)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path, return_numpy=False, place=None, **configs):
    """The saved object with its Tensors on ``place`` (default: the
    current place), or as numpy arrays with ``return_numpy``."""
    device = None if return_numpy else place_device(place)
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if not (isinstance(obj, dict) and _CKPT_KEY in obj):
        raise ValueError(f"{path!r} is not a paddle_tpu_torch checkpoint")
    if obj[_CKPT_KEY] > CKPT_FORMAT_VERSION:
        raise ValueError(f"checkpoint {path!r} uses format "
                         f"v{obj[_CKPT_KEY]}; this build reads up to "
                         f"v{CKPT_FORMAT_VERSION}")
    return _unpack(obj["payload"], device, return_numpy)

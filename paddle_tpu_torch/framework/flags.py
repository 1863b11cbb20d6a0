"""Runtime flag registry: port of paddle_tpu/framework/flags.py (reference:
C++ gflags surfaced as ``paddle.get_flags`` / ``paddle.set_flags``). A plain
dict with env-var overrides at import."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class _Flag:
    name: str
    default: Any
    value: Any
    help: str
    parser: Callable[[str], Any]


_REGISTRY: dict[str, _Flag] = {}


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


def define_flag(name: str, default, help: str = ""):
    if isinstance(default, bool):
        parser = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    value = default
    env = os.environ.get(name.upper())
    if env is not None:
        value = parser(env)
    _REGISTRY[name] = _Flag(name, default, value, help, parser)


def get_flags(flags=None) -> dict:
    if flags is None:
        return {k: f.value for k, f in _REGISTRY.items()}
    if isinstance(flags, str):
        flags = [flags]
    return {k: _REGISTRY[k].value for k in flags}


def set_flags(flags: dict):
    for k, v in flags.items():
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k!r}")
        f = _REGISTRY[k]
        f.value = f.parser(v) if isinstance(v, str) else v


def flag(name: str):
    return _REGISTRY[name].value


define_flag("FLAGS_use_pallas_kernels", True,
            "Attention without a mask runs the hand-written flash kernels "
            "(forward, dq, dk/dv) where the shape rule allows; off, it runs "
            "the plain composite. The name is the reference's.")

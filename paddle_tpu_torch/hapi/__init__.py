"""High-level API: port of paddle_tpu/hapi (reference: python/paddle/hapi/model.py — paddle.Model
with fit/evaluate/predict + callbacks; summary; flops)."""
from .model import Model
from .summary import summary, flops
from . import callbacks

"""The port's init_params (paddle_tpu_torch/models/gpt.py) against the
reference's paddle_tpu.models.gpt.init_params on the CPU: the same seed
gives the same weights, leaf by leaf and bit for bit, in f32 and in bf16
(where w_o and w_out are divided after the cast to bf16)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.framework import prng
from paddle_tpu_torch.models import gpt as tg

_DTYPES = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}


def _leaves(tree, prefix=""):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{name}/")
        else:
            yield prefix + name, v


def _bits(a) -> np.ndarray:
    """The bit patterns of a float32 or bfloat16 array, as uint32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16).astype(np.uint32)
    return a.view(np.uint32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("seed", [0, 5])
def test_init_params_equals_reference(dtype, seed):
    tdt, jdt = _DTYPES[dtype]
    ref = dict(_leaves(jax.device_get(jg.init_params(
        dataclasses.replace(jg.gpt_tiny(), dtype=jdt), seed))))
    got = dict(_leaves(tg.init_params(
        dataclasses.replace(tg.gpt_tiny(), dtype=tdt), seed, device="cpu")))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.dtype == tdt and tuple(g.shape) == np.shape(r), name
        np.testing.assert_array_equal(_torch_bits(g), _bits(r),
                                      err_msg=name)


def test_init_draws_in_blocks_and_by_layer(monkeypatch):
    """Drawn a few rows (or one layer) at a time through the counter
    offset, a leaf equals its whole draw; ``rows`` draws one layer."""
    cfg = tg.gpt_tiny(dtype=torch.bfloat16)
    whole = tg.init_params(cfg, 2, device="cpu")
    monkeypatch.setattr(tg, "_DRAW_ELEMS", 1000)   # 1000 elements a draw
    blocked = tg.init_params(cfg, 2, device="cpu")
    for (name, a), (_, b) in zip(_leaves(whole), _leaves(blocked)):
        assert torch.equal(a, b), name
    ks = prng.split(prng.PRNGKey(2), 10)
    shape = tg._shapes(cfg)["blocks"]["w_out"]
    layer = tg.init_leaf(ks[5], shape, cfg, "cpu", div=(2 * 4) ** 0.5,
                         rows=range(2, 3))
    assert layer.shape == (1, *shape[1:])
    assert torch.equal(layer[0], whole["blocks"]["w_out"][2])


def test_init_matrices_have_the_reference_scale():
    cfg = tg.gpt_tiny(hidden=128, n_layers=2)
    p = tg.init_params(cfg, 0, device="cpu")
    assert abs(p["wte"].std().item() - 0.02) < 1e-3
    assert abs(p["blocks"]["w_out"].std().item() - 0.01) < 1e-3  # / sqrt(4)
    assert torch.equal(p["blocks"]["ln1_g"], torch.ones(2, 128))
    assert not p["blocks"]["b_qkv"].any()

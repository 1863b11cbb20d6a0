"""Shared pieces of the eager-surface parity tests (tests/test_torch_eager_*):
the reference package and the port side by side on the CPU, and the one
helper that carries a reference Layer's weights into the port's."""
import numpy as np

import paddle_tpu as P
import paddle_tpu_torch as T

T.set_device("cpu")


def to_np(t) -> np.ndarray:
    """A Tensor of either package (or an array) as a float-faithful numpy
    array (bf16 widened to f32)."""
    a = np.asarray(t.numpy() if hasattr(t, "numpy") else t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def load_reference_state(port_layer, ref_layer):
    """Give ``port_layer`` the reference Layer's weights: the reference's
    ``state_dict()`` as numpy arrays, loaded by paddle's keys through
    ``set_state_dict``. Keys must match both ways."""
    state = {k: np.asarray(v.numpy()) for k, v in
             ref_layer.state_dict().items()}
    missing, unexpected = port_layer.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)
    return port_layer


def pair(arr, stop_gradient=True):
    """The same numpy input as a reference Tensor and a port Tensor."""
    return (P.to_tensor(arr, stop_gradient=stop_gradient),
            T.to_tensor(arr, stop_gradient=stop_gradient))


def assert_close(a, b, tol, what=""):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=what)


def seed_both(s):
    P.seed(s)
    T.seed(s)

"""paddle.inference: port of paddle_tpu/inference/__init__.py.

The predictor runs a ``jit.save``d program: ``Config(path)`` names it,
``create_predictor`` loads the ``torch.export`` program onto the card
(``Config.disable_gpu()`` asks for the CPU) and :class:`Predictor` keeps
the reference's handle surface (``get_input_handle`` / ``copy_from_cpu``
/ ``run`` / ``get_output_handle`` / ``copy_to_cpu``). The outputs stay on
the device until ``copy_to_cpu`` (or the list form ``run(inputs)``)
reads them. ``clone()`` shares the loaded program and its weights.
``convert_to_mixed_precision`` is not ported yet.

``GenerationSession`` is the slot-based serving session of the flagship
GPT (:mod:`.generation`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import to_torch
from .generation import GenerationSession, eager_ticks

__all__ = ["Config", "PrecisionType", "PlaceType", "PredictorTensor",
           "Predictor", "create_predictor", "GenerationSession",
           "eager_ticks"]


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


class PlaceType:
    kCPU = "cpu"
    kTPU = "tpu"
    kGPU = "gpu"


class Config:
    """Reference: paddle_infer::Config / AnalysisConfig."""

    def __init__(self, prog_file=None, params_file=None):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self.model_path = prog_file
        self.params_path = params_file
        self._device = "gpu"
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._enable_memory_optim = True

    def set_model(self, prog, params=None):
        self.model_path = prog[:-8] if prog.endswith(".pdmodel") else prog
        self.params_path = params

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device, self._device_id = "gpu", int(device_id)

    def enable_tpu(self, device_id=0):
        self.enable_use_gpu(device_id=device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device == "gpu"

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = flag

    def switch_ir_optim(self, flag=True):
        pass

    def enable_tensorrt_engine(self, *a, **k):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def _torch_device(self):
        from ..framework.place import place_device
        return place_device("cpu" if self._device == "cpu"
                            else f"gpu:{self._device_id}")


class PredictorTensor:
    """ZeroCopyTensor-style handle."""

    def __init__(self, name, owner, is_input, index):
        self.name = name
        self._owner = owner
        self._is_input = is_input
        self._index = index

    def copy_from_cpu(self, arr: np.ndarray):
        self._owner._inputs[self._index] = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return _host(self._owner._outputs[self._index])

    def reshape(self, shape):
        pass

    def shape(self):
        if self._is_input:
            a = self._owner._inputs.get(self._index)
            return list(a.shape) if a is not None else []
        return list(self._owner._outputs[self._index].shape)


def _host(v: torch.Tensor) -> np.ndarray:
    from ..tensor import _to_numpy
    return _to_numpy(v)


class Predictor:
    def __init__(self, config: Config):
        from ..jit import load_program
        self._config = config
        self._device = config._torch_device()
        self._program, self._meta = load_program(config.model_path,
                                                 self._device)
        specs = self._meta.get("input_specs", [])
        self._n_inputs = len(specs) or 1
        # host inputs are cast to the saved specs' dtypes (the reference's
        # folded dtypes: an int64 array feeds an int32 spec)
        self._dtypes = [to_torch(d) for _, d, _ in specs] or [None]
        self._inputs = {}
        self._outputs = []

    def get_input_names(self):
        return [f"input_{i}" for i in range(self._n_inputs)]

    def get_output_names(self):
        n = len(self._outputs) if self._outputs else 1
        return [f"output_{i}" for i in range(n)]

    def get_input_handle(self, name):
        idx = int(name.rsplit("_", 1)[-1]) if "_" in name else 0
        return PredictorTensor(name, self, True, idx)

    def get_output_handle(self, name):
        idx = int(name.rsplit("_", 1)[-1]) if "_" in name else 0
        return PredictorTensor(name, self, False, idx)

    def run(self, inputs=None):
        """Run the program on the inputs given (numpy arrays) or copied in
        by the handles; with ``inputs`` returns the outputs as numpy
        arrays, as the reference does."""
        from ..tensor import _from_numpy
        arrs = inputs if inputs is not None else [
            self._inputs[i] for i in range(self._n_inputs)]
        vals = [_from_numpy(np.asarray(a)).to(self._device, dtype)
                for a, dtype in zip(arrs, self._dtypes)]
        with torch.no_grad():
            out = self._program(*vals)
        self._outputs = list(torch.utils._pytree.tree_leaves(out))
        if inputs is not None:
            return [_host(o) for o in self._outputs]
        return None

    def clone(self):
        p = object.__new__(Predictor)
        p.__dict__.update(self.__dict__)
        p._inputs = {}
        p._outputs = []
        return p


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)

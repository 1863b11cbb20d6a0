"""Layer: port of paddle_tpu/nn/layer.py (reference:
``python/paddle/nn/layer/layers.py`` — parameter/sublayer registration via
__setattr__, state_dict, train/eval, hooks).

A :class:`Layer` is a ``torch.nn.Module``: each paddle :class:`Parameter`
registers its value (a ``torch.nn.Parameter``) in torch's ``_parameters``,
each sublayer in ``_modules``, each buffer's value in ``_buffers``, so
torch sees the model whole. The paddle objects live beside them
(``_pd_params``, ``_pd_buffers``) and attribute access returns those.
Where a paddle method has a torch namesake with other semantics, paddle's
wins: ``parameters()`` returns a list, ``train()`` takes no mode,
``state_dict()`` holds paddle's keys and Tensors, ``to()`` takes paddle's
arguments, and the forward hooks keep paddle's signatures.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterator

import numpy as np
import torch

from ..framework.dtype import convert_dtype, get_default_dtype, to_torch
from ..framework.place import place_device
from ..tensor import Parameter, Tensor, _from_numpy
from .initializer import Constant, ParamAttr, XavierNormal, _to_initializer


class HookRemoveHelper:
    def __init__(self, hooks: dict, hook_id: int):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer(torch.nn.Module):
    def __init__(self, name_scope: str | None = None, dtype=None):
        super().__init__()
        object.__setattr__(self, "_pd_params", OrderedDict())
        object.__setattr__(self, "_pd_buffers", OrderedDict())
        object.__setattr__(self, "_non_persistable_buffer_names", set())
        self._dtype = convert_dtype(dtype) if dtype else get_default_dtype()
        self._forward_pre_hooks_pd: dict[int, Callable] = {}
        self._forward_post_hooks_pd: dict[int, Callable] = {}
        self._hook_id = 0
        self._name_scope = name_scope or self.__class__.__name__.lower()

    @property
    def _sub_layers(self):
        return self._modules

    # ---- attribute magic -------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_pd_params")
        buffers = self.__dict__.get("_pd_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning parameters")
            self._modules.pop(name, None)
            buffers.pop(name, None)
            self._buffers.pop(name, None)
            self.__dict__.pop(name, None)
            params[name] = value
            self._parameters[name] = value._value
        elif isinstance(value, torch.nn.Module):
            if params is not None:
                params.pop(name, None)
                self._parameters.pop(name, None)
                buffers.pop(name, None)
                self._buffers.pop(name, None)
            super().__setattr__(name, value)
        else:
            if params is not None and name in params:
                if value is None:
                    params.pop(name)
                    self._parameters.pop(name, None)
                    object.__setattr__(self, name, None)
                    return
                raise TypeError(f"cannot assign non-Parameter to parameter "
                                f"slot {name!r}")
            if buffers is not None and name in buffers and (
                    value is None or isinstance(value, Tensor)):
                buffers[name] = value
                self._buffers[name] = None if value is None else value._value
                return
            if "_modules" in self.__dict__:
                self._modules.pop(name, None)
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        d = self.__dict__
        for registry in ("_pd_params", "_modules", "_pd_buffers"):
            reg = d.get(registry)
            if reg is not None and name in reg:
                return reg[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute {name!r}")

    def __delattr__(self, name):
        for registry, tr in (("_pd_params", "_parameters"),
                             ("_modules", None),
                             ("_pd_buffers", "_buffers")):
            d = self.__dict__.get(registry)
            if d is not None and name in d:
                del d[name]
                if tr is not None:
                    self.__dict__[tr].pop(name, None)
                return
        object.__delattr__(self, name)

    def __dir__(self):
        return list(super().__dir__()) + list(self._pd_params) + \
            list(self._pd_buffers)

    # ---- construction helpers -------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Parameter:
        """Reference: Layer.create_parameter -> LayerHelper.create_parameter:
        the attr's initializer, else the default one, else zeros for a bias
        and XavierNormal for a weight."""
        dtype = convert_dtype(dtype) if dtype else self._dtype
        attr = ParamAttr._to_attr(attr)
        if attr is not None and attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = _to_initializer(default_initializer)
        elif is_bias:
            init = Constant(0.0)
        else:
            init = XavierNormal()
        value = init(tuple(int(s) for s in shape), dtype)
        p = Parameter(value, trainable=attr.trainable if attr else True,
                      name=attr.name if attr and attr.name else None)
        if attr is not None:
            p.optimize_attr["learning_rate"] = attr.learning_rate
            p.regularizer = attr.regularizer
            p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name: str, parameter: Parameter | None):
        if parameter is None:
            self._pd_params[name] = None
            self._parameters[name] = None
        else:
            setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._modules[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor: Tensor | None,
                        persistable: bool = True):
        self._pd_buffers[name] = tensor
        self._buffers[name] = None if tensor is None else tensor._value
        if not persistable:
            self._non_persistable_buffer_names.add(name)

    # ---- iteration -------------------------------------------------------
    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, recurse=None,
                         remove_duplicate: bool = True
                         ) -> Iterator[tuple[str, Parameter]]:
        """(name, Parameter) pairs by paddle's keys. A torch-style call
        (``recurse=``, as torch's own ``parameters()`` makes) gets torch's
        (name, torch.nn.Parameter) pairs."""
        if recurse is not None:
            yield from torch.nn.Module.named_parameters(
                self, prefix, recurse, remove_duplicate)
            return
        seen = set()
        for _, layer, path in self._walk(prefix):
            for pname, p in layer._pd_params.items():
                if p is not None and id(p) not in seen:
                    seen.add(id(p))
                    yield (f"{path}.{pname}" if path else pname), p
            if not include_sublayers:
                break

    def parameters(self, include_sublayers: bool = True) -> list[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      recurse=None, remove_duplicate: bool = True):
        if recurse is not None:
            yield from torch.nn.Module.named_buffers(
                self, prefix, recurse, remove_duplicate)
            return
        seen = set()
        for _, layer, path in self._walk(prefix):
            for bname, b in layer._pd_buffers.items():
                if b is not None and id(b) not in seen:
                    seen.add(id(b))
                    yield (f"{path}.{bname}" if path else bname), b
            if not include_sublayers:
                break

    def buffers(self, include_sublayers: bool = True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        if include_self:
            yield prefix, self
        for name, sub in self._modules.items():
            if sub is None:
                continue
            path = f"{prefix}.{name}" if prefix else name
            yield path, sub
            yield from sub.named_sublayers(prefix=path)

    def sublayers(self, include_self: bool = False) -> list["Layer"]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def _walk(self, prefix: str = ""):
        """(name, layer, dotted-path) DFS including self."""
        stack = [(self._name_scope, self, prefix)]
        while stack:
            name, layer, path = stack.pop()
            yield name, layer, path
            for cname, child in reversed(list(layer._modules.items())):
                if child is not None:
                    cpath = f"{path}.{cname}" if path else cname
                    stack.append((cname, child, cpath))

    def apply(self, fn: Callable):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ---- train / eval ----------------------------------------------------
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    # ---- dtype / device --------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move parameters and buffers to ``device`` and/or cast the
        floating ones to ``dtype``; each keeps its identity (its torch
        value's ``.data`` is replaced)."""
        td = to_torch(dtype) if dtype is not None else None
        dev = place_device(device) if device is not None else None

        def move(v):
            if td is not None and v.is_floating_point():
                v.data = v.data.to(td)
            if dev is not None:
                v.data = v.data.to(dev)

        with torch.no_grad():
            for p in self.parameters():
                move(p._value)
            for _, b in self.named_buffers():
                move(b._value)
        if td is not None:
            for layer in self.sublayers(include_self=True):
                layer._dtype = convert_dtype(dtype)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # ---- state dict ------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True):
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(
                prefix=structured_name_prefix,
                include_sublayers=include_sublayers):
            dest[name] = p
        for name, b in self.named_buffers(
                prefix=structured_name_prefix,
                include_sublayers=include_sublayers):
            dest[name] = b
        for _, layer, path in self._walk(structured_name_prefix):
            for bname in layer._non_persistable_buffer_names:
                dest.pop(f"{path}.{bname}" if path else bname, None)
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy values into this layer's parameters and buffers by paddle's
        keys (Tensors, torch tensors or numpy arrays, e.g. the reference's
        ``state_dict()`` as numpy); returns (missing, unexpected) keys."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        for k, v in state_dict.items():
            if k not in own:
                continue
            tgt = own[k]._value
            if isinstance(v, Tensor):
                val = v._value
            elif isinstance(v, torch.Tensor):
                val = v
            else:
                val = _from_numpy(np.asarray(v))
            if tuple(tgt.shape) != tuple(val.shape):
                raise ValueError(f"shape mismatch for {k}: expect "
                                 f"{tuple(tgt.shape)}, got "
                                 f"{tuple(val.shape)}")
            with torch.no_grad():
                tgt.copy_(val.to(device=tgt.device, dtype=tgt.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    # ---- hooks -----------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs)``; a non-None result replaces the
        inputs."""
        self._hook_id += 1
        self._forward_pre_hooks_pd[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks_pd, self._hook_id)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a non-None result replaces the
        outputs."""
        self._hook_id += 1
        self._forward_post_hooks_pd[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks_pd, self._hook_id)

    # ---- call ------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks_pd.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks_pd.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    # ---- misc ------------------------------------------------------------
    def full_name(self):
        return self._name_scope

    def extra_repr(self) -> str:
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, sub in self._modules.items():
            sub_repr = "\n  ".join(repr(sub).split("\n"))
            lines.append(f"({name}): {sub_repr}")
        main = self.__class__.__name__ + "("
        if extra and not lines:
            return main + extra + ")"
        body = "\n  ".join([extra] * bool(extra) + lines)
        return main + "\n  " + body + "\n)" if body else main + ")"


class Sequential(Layer):
    """paddle.nn.Sequential."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """paddle.nn.LayerList."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        self._modules[list(self._modules)[idx]] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self._modules[str(i)] = l

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return list(self._pd_params.values())[idx]

    def __len__(self):
        return len(self._pd_params)

    def __iter__(self):
        return iter(self._pd_params.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._pd_params)), parameter)
        return self

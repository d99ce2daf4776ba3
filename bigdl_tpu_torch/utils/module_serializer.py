"""Module topology as a JSON spec (counterpart of
``bigdl_tpu.utils.module_serializer``; reference
utils/serializer/ModuleSerializer.scala:34).

A module's spec is its class name, its captured constructor arguments
(:class:`~bigdl_tpu_torch.nn.module.Module` records them), the children
added after construction, and its name, gradient scales and mode. The
spec has the JAX package's shape and class names, so a ``module.json``
written by either package builds the other's tree: a container's
children given to its constructor are arguments (``n_ctor`` counts
them), those added with ``add`` are ``children``. Value objects (an
initialization method, a regularizer) are their class name and public
attributes, which the port's classes share with the JAX package's.
Placement is not identity: a ``generator`` or ``device`` argument is
left out.

A Graph's spec is its nodes' specs in execution order, its edges
``[source, destination, slot]`` by those positions, and its input and
output positions, as the JAX package writes it.

Classes resolve through :func:`register_module_class`'s registry, then
the port's ``nn``, initialization methods, regularizers and models.
"""
from __future__ import annotations

import base64
import inspect
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["from_spec", "register_module_class", "to_spec"]

_REGISTRY: Dict[str, type] = {}
#: constructor arguments that place a module rather than define it
_PLACEMENT = ("device", "generator")


def register_module_class(cls: type, name: Optional[str] = None) -> type:
    """Register a class so :func:`from_spec` finds it by name
    (ModuleSerializer.registerModule)."""
    _REGISTRY[name or cls.__name__] = cls
    return cls


def _resolve(name: str) -> type:
    if name in _REGISTRY:
        return _REGISTRY[name]
    import bigdl_tpu_torch.models as models
    import bigdl_tpu_torch.nn as nn
    import bigdl_tpu_torch.nn.initialization as initialization
    import bigdl_tpu_torch.optim.regularizer as regularizer
    for where in (nn, initialization, regularizer, models):
        if hasattr(where, name):
            return getattr(where, name)
    raise KeyError(f"unknown module class {name!r}; register it with "
                   "bigdl_tpu_torch.utils.module_serializer."
                   "register_module_class")


def _placement(v) -> bool:
    return isinstance(v, (torch.Generator, torch.device))


def _encode_value(v) -> Any:
    from bigdl_tpu_torch.nn.module import Module
    from bigdl_tpu_torch.utils.table import Table
    if isinstance(v, Module):
        return {"__module__": to_spec(v)}
    if isinstance(v, (bytes, bytearray)):
        return {"__bytes__": base64.b64encode(bytes(v)).decode("ascii")}
    if isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        return {"__ndarray__": arr.tolist(), "dtype": str(arr.dtype)}
    if isinstance(v, Table):
        return {"__table__": {str(k): _encode_value(x)
                              for k, x in v.items()}}
    if isinstance(v, dict):
        return {"__dict__": {k: _encode_value(x) for k, x in v.items()}}
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_value(x) for x in v]}
    if isinstance(v, list):
        return [_encode_value(x) for x in v]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    # value objects (initialization methods, regularizers): class name
    # and public attributes
    state = {k: _encode_value(x) for k, x in vars(v).items()
             if not k.startswith("_")}
    register_module_class(type(v))
    return {"__obj__": type(v).__name__, "state": state}


def _decode_value(v):
    from bigdl_tpu_torch.utils.table import Table
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    if not isinstance(v, dict):
        return v
    if "__module__" in v:
        return from_spec(v["__module__"])
    if "__bytes__" in v:
        return base64.b64decode(v["__bytes__"])
    if "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"])
    if "__table__" in v:
        t = Table()
        for k, x in v["__table__"].items():
            t[int(k) if k.lstrip("-").isdigit() else k] = _decode_value(x)
        return t
    if "__dict__" in v:
        return {k: _decode_value(x) for k, x in v["__dict__"].items()}
    if "__tuple__" in v:
        return tuple(_decode_value(x) for x in v["__tuple__"])
    if "__obj__" in v:
        cls = _resolve(v["__obj__"])
        obj = cls.__new__(cls)
        obj.__dict__.update(
            {k: _decode_value(x) for k, x in v["state"].items()})
        return obj
    return {k: _decode_value(x) for k, x in v.items()}


def to_spec(module) -> Dict[str, Any]:
    """The JSON-able spec of a module tree."""
    from bigdl_tpu_torch.nn.container import Container
    from bigdl_tpu_torch.nn.graph import Graph
    from bigdl_tpu_torch.nn.module import Module

    if isinstance(module, Graph):
        return _graph_to_spec(module)
    args = [a for a in getattr(module, "_init_args", ())
            if not _placement(a)]
    kwargs = {k: v for k, v in getattr(module, "_init_kwargs", {}).items()
              if k not in _PLACEMENT and not _placement(v)}
    spec: Dict[str, Any] = {
        "class": type(module).__name__,
        "args": [_encode_value(a) for a in args],
        "kwargs": {k: _encode_value(v) for k, v in kwargs.items()},
    }
    _meta_to_spec(module, spec)
    if isinstance(module, Container):
        n_ctor = sum(1 for a in args if isinstance(a, Module))
        extra = list(module._modules.values())[n_ctor:]
        if extra:
            spec["n_ctor"] = n_ctor
            spec["children"] = [to_spec(m) for m in extra]
    return spec


def _meta_to_spec(module, spec: Dict[str, Any]) -> None:
    if module._name is not None:
        spec["name"] = module._name
    if module.scale_w != 1.0 or module.scale_b != 1.0:
        spec["scales"] = [module.scale_w, module.scale_b]
    if not module.training:
        spec["eval_mode"] = True


def _meta_from_spec(module, spec: Dict[str, Any]) -> None:
    if "name" in spec:
        module.set_name(spec["name"])
    if "scales" in spec:
        module.scale_w, module.scale_b = spec["scales"]
    if spec.get("eval_mode"):
        # this module's flag only; each child restores its own
        module.training = False


def _graph_to_spec(g) -> Dict[str, Any]:
    pos = {id(n): i for i, n in enumerate(g.exec_order)}
    spec = {
        "class": "Graph",
        "nodes": [to_spec(n.element) for n in g.exec_order],
        "edges": [[pos[id(p)], pos[id(n)], e.from_index]
                  for n in g.exec_order for p, e in n.prevs],
        "inputs": [pos[id(n)] for n in g.input_nodes],
        "outputs": [pos[id(n)] for n in g.output_nodes],
    }
    _meta_to_spec(g, spec)
    return spec


def _graph_from_spec(spec: Dict[str, Any]):
    from bigdl_tpu_torch.nn.graph import Graph
    from bigdl_tpu_torch.utils.directed_graph import Edge, Node

    nodes = [Node(from_spec(s)) for s in spec["nodes"]]
    for src, dst, from_index in spec["edges"]:
        nodes[src].add(nodes[dst], Edge(from_index))
    g = Graph([nodes[i] for i in spec["inputs"]],
              [nodes[i] for i in spec["outputs"]])
    _meta_from_spec(g, spec)
    return g


def from_spec(spec: Dict[str, Any]):
    """Rebuild a module tree (on the CPU, in the spec's modes) from its
    spec; its weights come separately."""
    if spec.get("class") == "Graph":
        return _graph_from_spec(spec)
    cls = _resolve(spec["class"])
    args = [_decode_value(a) for a in spec.get("args", [])]
    kwargs = {k: _decode_value(v) for k, v in spec.get("kwargs", {}).items()}
    if "device" in inspect.signature(cls).parameters:
        # placement is left out of a spec: a class that places itself
        # (the TransformerLM, on the card by default) is built on the CPU
        kwargs["device"] = "cpu"
    module = cls(*args, **kwargs)
    _meta_from_spec(module, spec)
    children = spec.get("children", [])
    if children:
        # a constructor may have built children of its own beyond those
        # it was given: add only the rest
        already_built = len(module._modules) - spec.get("n_ctor", 0)
        for child_spec in children[max(0, already_built):]:
            module.add(from_spec(child_spec))
    return module

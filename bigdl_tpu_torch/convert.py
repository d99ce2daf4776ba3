"""Carry a ``bigdl_tpu`` param tree (and state tree) into a port module.

The JAX package's parameters are a nested dict (``{"block_0": {"attn":
{"wq": ...}}}``); the port's modules name the same leaves
``block_0.attn.wq`` and keep the same layouts, so the map is the path
with ``/`` spelled ``.`` — no transpose anywhere. The model state (a
BatchNormalization's ``running_mean`` / ``running_var``) is a second
tree of the same shape; the port holds it in buffers under the same
names. numpy is the wire format: the trees' leaves may be numpy arrays
or anything ``numpy.asarray`` accepts.

The JAX containers key every child by its index, so a child without
parameters (a ReLU) or without state (a convolution) is an empty dict
in the JAX trees, and the JAX package's ``apply`` indexes it. The
exported trees have that full shape (:func:`jax_tree`); the loaders
ignore empty dicts.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["export_params", "export_state", "flatten_params", "jax_tree",
           "load_jax_params", "param_tree"]


def flatten_params(params: Mapping, prefix: str = "") -> Dict[str, object]:
    """``{"a": {"b": x}}`` → ``{"a.b": x}`` (leaves untouched)."""
    out: Dict[str, object] = {}
    for key, val in params.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten_params(val, name + "."))
        else:
            out[name] = val
    return out


def _checked(kind: str, model: torch.nn.Module, tree: Mapping,
             own: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{name: array}`` for every tensor ``own`` names, from ``tree``.
    Every tensor must be covered and every leaf used, with equal
    shapes; anything else raises."""
    flat = flatten_params(tree)
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"{kind} tree does not match {type(model).__name__}: "
                       f"missing {missing}, unexpected {extra}")
    arrays = {}
    for name, p in own.items():
        a = np.asarray(flat[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {a.shape} != {kind} "
                             f"shape {tuple(p.shape)}")
        arrays[name] = a
    return arrays


def load_jax_params(model: torch.nn.Module, params: Optional[Mapping],
                    state: Optional[Mapping] = None) -> torch.nn.Module:
    """Copy a JAX param tree into ``model``'s parameters in place, and
    with ``state`` the JAX state tree into its buffers, and return the
    model (``params=None`` copies the state alone). Every parameter
    (and, with ``state``, every buffer) must be covered and every leaf
    used, with equal shapes; anything else raises before a single value
    is copied. Values are cast to each tensor's dtype and device."""
    pairs = []
    if params is not None:
        own = dict(model.named_parameters())
        pairs.append((own, _checked("param", model, params, own)))
    if state is not None:
        own = dict(model.named_buffers())
        pairs.append((own, _checked("state", model, state, own)))
    with torch.no_grad():
        for own, arrays in pairs:
            for name, t in own.items():
                # np.array copies: JAX hands out read-only buffers
                t.copy_(torch.from_numpy(np.array(arrays[name])))
    return model


def param_tree(named) -> Dict[str, object]:
    """``[(dotted name, tensor)]`` -> the nested tree of numpy copies."""
    tree: Dict[str, object] = {}
    for name, p in named:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().cpu().numpy().copy()
    return tree


def jax_tree(model: torch.nn.Module, named) -> Dict[str, object]:
    """:func:`param_tree` of ``named`` (``[(dotted name, tensor)]`` of
    ``model``'s tensors) in the JAX trees' full shape: every child of a
    container is present, an empty dict where it holds no leaf, and so
    is every child a module names in its ``jax_tree_children`` (the
    TransformerLM's blocks and each block's ``mlp``, which the JAX
    state tree always holds)."""
    from bigdl_tpu_torch.nn.container import Container

    tree = param_tree(named)
    for name, m in model.named_modules():
        keys = list(m._modules) if isinstance(m, Container) \
            else getattr(m, "jax_tree_children", ())
        if keys:
            node = tree
            for key in (name.split(".") if name else ()):
                node = node.setdefault(key, {})
            for key in keys:
                node.setdefault(key, {})
    return tree


def export_params(model: torch.nn.Module) -> Dict[str, object]:
    """The inverse of :func:`load_jax_params`: ``model``'s parameters as
    the JAX package's nested param tree (``block_0.attn.wq`` →
    ``{"block_0": {"attn": {"wq": ...}}}``, :func:`jax_tree`) of numpy
    arrays, copied to the host in the parameters' dtype."""
    return jax_tree(model, model.named_parameters())


def export_state(model: torch.nn.Module) -> Dict[str, object]:
    """The inverse of ``load_jax_params(state=)``: ``model``'s buffers
    as the JAX package's nested state tree (:func:`jax_tree`) of numpy
    arrays."""
    return jax_tree(model, model.named_buffers())

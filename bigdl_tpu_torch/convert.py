"""Carry a ``bigdl_tpu`` param tree into a port module.

The JAX package's parameters are a nested dict (``{"block_0": {"attn":
{"wq": ...}}}``); the port's modules name the same leaves
``block_0.attn.wq`` and keep the same ``[in, out]`` layouts, so the map
is the path with ``/`` spelled ``.`` — no transpose anywhere. numpy is
the wire format: the tree's leaves may be numpy arrays or anything
``numpy.asarray`` accepts.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["flatten_params", "load_jax_params"]


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


def load_jax_params(model: torch.nn.Module, params: Mapping
                    ) -> torch.nn.Module:
    """Copy a JAX param tree into ``model``'s parameters in place and
    return the model. Every parameter must be covered and every leaf
    used, with equal shapes; anything else raises before a single
    value is copied. Values are cast to each parameter's dtype and
    device."""
    flat = flatten_params(params)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"param tree does not match {type(model).__name__}: "
                       f"missing {missing}, unexpected {extra}")
    arrays = {}
    for name, p in own.items():
        a = np.asarray(flat[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {a.shape} != parameter "
                             f"shape {tuple(p.shape)}")
        arrays[name] = a
    with torch.no_grad():
        for name, p in own.items():
            # np.array copies: JAX hands out read-only buffers
            p.copy_(torch.from_numpy(np.array(arrays[name])))
    return model

"""ZeRO weight-update sharding over the data axis (counterpart of
``bigdl_tpu.parallel.zero``).

The shard plan is the JAX package's: each leaf's FIRST dim that divides
the data axis is sharded over it (:func:`extend_spec`), and a leaf with
none (a scalar, an odd-sized bias) stays whole on every rank. The JAX
package gets its collectives from sharding annotations; the port's
driver (``optim.optimizer``) runs them by hand through
:mod:`bigdl_tpu_torch.parallel.comm`, one process a rank:

- stage 1: gradients all-reduced; each rank updates its shard of every
  sharded leaf with its shard of the optimizer state; the parameters
  are all-gathered;
- stage 2: the gradients of sharded leaves are reduce-scattered
  instead, so a rank only ever holds its slice of the summed gradient;
- stage 3: the parameters too stay sharded between steps; a step
  all-gathers them whole at its start (the JAX package gathers each
  layer just in time inside the compiled forward, a memory lever the
  port has not taken), so the peak holds the whole parameters in the
  compute dtype during the step.

The per-rank memory gauges are ``train/memory/params_bytes_per_chip``
and ``train/memory/opt_state_bytes_per_chip`` (:func:`record_memory_gauges`,
read off the tensors a rank actually holds at rest).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch import telemetry

__all__ = ["ZeroConfig", "extend_spec", "record_memory_gauges",
           "shard_dim", "shard_view", "tree_bytes", "tree_zero_specs"]

_OPT_BYTES = telemetry.gauge(
    "train/memory/opt_state_bytes_per_chip",
    "bytes of optimizer state resident per rank after sharding")
_PARAM_BYTES = telemetry.gauge(
    "train/memory/params_bytes_per_chip",
    "bytes of parameters resident per rank after sharding")


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """Weight-update sharding policy over the ``data`` mesh axis.

    ``stage`` — 0: off (pure data parallelism); 1: optimizer state
    sharded; 2: + gradients reduce-scattered and updated a shard at a
    time, one parameter all-gather a step; 3: + parameters sharded at
    rest. ``data_axis`` — the mesh axis to shard over."""

    stage: int = 2
    data_axis: str = "data"

    def __post_init__(self):
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(
                f"ZeroConfig.stage must be 0, 1, 2 or 3, got {self.stage}")

    def active_on(self, mesh) -> bool:
        """True when the policy does anything on ``mesh``: a mesh whose
        data axis splits, and a stage above 0."""
        return (self.stage > 0 and mesh is not None
                and mesh.shape.get(self.data_axis, 1) > 1)


def extend_spec(base: Tuple, shape: Sequence[int], ndev: int,
                data_axis: str) -> Tuple:
    """``base`` (a spec: one entry a dim, an axis name or None; ``()``
    is replicated) with the FIRST free dim whose size divides ``ndev``
    sharded over ``data_axis``: the JAX package's rule, entry for
    entry (``tuple(jax_spec)`` equals the result). A leaf with no such
    dim keeps ``base``."""
    base = tuple(base)
    if ndev <= 1 or not len(shape):
        return base
    entries = list(base) + [None] * (len(shape) - len(base))
    used = set()
    for e in entries:
        if e is not None:
            used.update((e,) if isinstance(e, str) else tuple(e))
    if data_axis in used:
        return base
    for d, e in enumerate(entries):
        if e is None and shape[d] > 0 and shape[d] % ndev == 0:
            entries[d] = data_axis
            return tuple(entries)
    return base


def shard_dim(shape: Sequence[int], ndev: int) -> Optional[int]:
    """The dim :func:`extend_spec` shards (None: the leaf stays
    whole)."""
    spec = extend_spec((), tuple(shape), ndev, "data")
    return spec.index("data") if "data" in spec else None


def shard_view(t: torch.Tensor, dim: Optional[int], index: int,
               ndev: int) -> torch.Tensor:
    """Shard ``index`` of ``ndev`` of ``t`` along ``dim`` (a view; ``t``
    itself when ``dim`` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // ndev
    return t.narrow(dim, index * n, n)


def tree_zero_specs(shapes: Dict[str, Sequence[int]], mesh,
                    config: ZeroConfig) -> Dict[str, Tuple]:
    """``{leaf name: spec}`` for a ``{name: shape}`` map under
    ``config`` on ``mesh`` (the JAX package's ``tree_zero_specs`` without
    TP rules, which wait for the next slice)."""
    ndev = mesh.shape.get(config.data_axis, 1)
    return {name: extend_spec((), tuple(shape), ndev, config.data_axis)
            for name, shape in shapes.items()}


def tree_bytes(tensors: Iterable) -> int:
    """Bytes of the tensors (lists and dicts walked): what a rank
    holds."""
    total = 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += tree_bytes(t.values())
        elif isinstance(t, (list, tuple)):
            total += tree_bytes(t)
    return total


def record_memory_gauges(params_bytes: int,
                         opt_state_bytes: int) -> Dict[str, int]:
    """Set the per-rank memory gauges; returns the two counts."""
    _PARAM_BYTES.set(params_bytes)
    _OPT_BYTES.set(opt_state_bytes)
    return {"params_bytes_per_chip": int(params_bytes),
            "opt_state_bytes_per_chip": int(opt_state_bytes)}

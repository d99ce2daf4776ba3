"""The port's mesh (counterpart of ``bigdl_tpu.parallel.mesh``).

The JAX package's mesh is an array of devices under one controller;
here a rank is a process, so a :class:`Mesh` is an array of global
ranks with named axes and, for each axis, the process group of this
rank's slice along it (one ``torch.distributed.new_group`` a slice,
made by every rank in the same order when the mesh is built). Its
``.shape`` is a dict, so ``ZeroConfig.active_on`` and
:func:`resolve_axis_mesh` read ``mesh.shape.get(axis, 1)`` as the JAX
code does. ``torch.distributed.device_mesh.DeviceMesh`` is not used: it
ties a device type to a backend and assumes one card a rank, and ranks
that share a card (gloo) are a supported layout here.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["Mesh", "data_parallel_mesh", "make_mesh", "resolve_axis_mesh"]


class Mesh:
    """Named axes over global ranks (row-major: the last axis varies
    fastest, as in ``np.reshape``).

    ``shape`` is ``{axis: size}`` in axis order, ``ranks`` the
    ``np.ndarray`` of global ranks, ``rank`` this process's global rank
    (0 without a process group), ``coords`` its index along each axis.
    :meth:`group` is the process group of this rank's slice along an
    axis (None for a size-1 axis). A mesh of more than one rank needs a
    started process group (``utils.engine.init_distributed``); without
    one it is a layout only (``shape`` and the shard plans work,
    :meth:`group` raises)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        import torch.distributed as dist

        sizes = [int(s) for s in axis_sizes]
        names = [str(a) for a in axis_names]
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not match sizes {sizes}")
        n = int(np.prod(sizes)) if sizes else 1
        started = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if started else 1
        if ranks is None:
            if started and n != world:
                raise ValueError(f"mesh wants {n} ranks, have {world}")
            ranks = range(n)
        ranks = np.asarray(list(ranks), dtype=np.int64)
        if ranks.size != n:
            raise ValueError(f"mesh wants {n} ranks, got {ranks.size}")
        self.ranks = ranks.reshape(sizes)
        self.axis_names = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.rank = dist.get_rank() if started else 0
        where = np.argwhere(self.ranks == self.rank)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(names, (int(c) for c in where[0]))) if len(where)
            else None)
        self._groups: Dict[str, object] = {}
        self.has_groups = started and n > 1
        if self.has_groups:
            self._make_groups()

    def _make_groups(self) -> None:
        import torch.distributed as dist

        from bigdl_tpu_torch.utils.engine import DEFAULT_TIMEOUT_S
        import datetime
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        for ax, name in enumerate(self.axis_names):
            if self.shape[name] == 1:
                continue
            # every slice along this axis, in a fixed order: each rank
            # makes every group, as new_group requires
            moved = np.moveaxis(self.ranks, ax, -1).reshape(
                -1, self.shape[name])
            for row in moved:
                members = [int(r) for r in row]
                group = dist.new_group(members, timeout=timeout)
                if self.rank in members:
                    self._groups[name] = group

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh does
        not have)."""
        if axis not in self.shape:
            return 0
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's slice along ``axis`` (None
        when the axis is missing or of size 1)."""
        if self.shape.get(axis, 1) == 1:
            return None
        if not self.has_groups:
            raise RuntimeError(
                f"mesh axis {axis!r} spans {self.shape[axis]} ranks but no "
                "process group was started: call utils.engine."
                "init_distributed() before building the mesh")
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of named axis sizes over ``ranks`` (default: every rank of
    the process group, or the one process without one)."""
    return Mesh(axis_sizes, axis_names, ranks)


def data_parallel_mesh() -> Mesh:
    """One ``data`` axis over every rank: the AllReduceParameter
    analogue."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    return Mesh([n], ["data"])


def resolve_axis_mesh(mesh, axis: str):
    """The mesh a parallelism axis lives on: ``mesh``, else the
    Engine's, and only when the axis is present with more than one
    rank. None means "run the local / dense path"."""
    if mesh is None:
        from bigdl_tpu_torch.utils import engine
        if engine.is_initialized():
            mesh = engine.mesh()
    if mesh is not None and axis in mesh.shape and mesh.shape[axis] > 1:
        return mesh
    return None

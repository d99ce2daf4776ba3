"""Sequence-parallel training policy (counterpart of
``bigdl_tpu.parallel.sequence``).

:class:`SeqParallelConfig` names the mesh axis the sequence dim is split
over and the kernel that runs attention across it: ``ring``
(:mod:`bigdl_tpu_torch.parallel.ring_attention`, K/V blocks rotating
around the axis) or ``ulysses`` (:mod:`bigdl_tpu_torch.parallel.ulysses`,
an all-to-all from sequence to heads, full-sequence attention for a
group of heads, and back). ``Optimizer.set_sequence_parallel`` installs
it around the forward (:func:`use_sequence_parallel`), and every
``MultiHeadAttention`` without its own ``ring_axis`` adopts it. Like
``ZeroConfig`` the policy is a quiet no-op where it cannot apply (no
mesh, the axis missing or of size 1): the dense path runs and the
``train/seq_parallel/degree`` gauge reads 1.

One process a rank: under the policy each rank of the axis holds
``S / n`` consecutive tokens of every row (rank ``r`` the positions
``r * S/n ..``), through the whole model; only attention talks across
the axis.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

from bigdl_tpu_torch import telemetry

__all__ = ["SeqParallelConfig", "active_sequence_parallel",
           "record_degree", "sequence_parallel_available",
           "use_sequence_parallel"]

_G_DEGREE = telemetry.gauge(
    "train/seq_parallel/degree",
    "active sequence-parallel mesh degree (1 = dense attention)")


def sequence_parallel_available() -> bool:
    """Whether this PyTorch build has ``torch.distributed``."""
    import torch.distributed as dist
    return dist.is_available()


@dataclass(frozen=True)
class SeqParallelConfig:
    """Which sequence-parallel kernel runs attention, over which axis.

    ``impl`` — ``"ring"`` or ``"ulysses"``; ``axis`` the mesh axis
    carrying the sequence dim; ``mesh`` the mesh (None: the Engine's)."""

    axis: str = "seq"
    impl: str = "ring"
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.impl not in ("ring", "ulysses"):
            raise ValueError(
                f"seq-parallel impl must be 'ring' or 'ulysses', got "
                f"{self.impl!r}")

    def resolve_mesh(self, mesh=None):
        """The mesh the policy runs on (None: it cannot apply here)."""
        from bigdl_tpu_torch.parallel.mesh import resolve_axis_mesh
        if not sequence_parallel_available():
            return None
        return resolve_axis_mesh(self.mesh if self.mesh is not None
                                 else mesh, self.axis)

    def degree(self, mesh=None) -> int:
        """The sequence-shard count the policy achieves (1: none)."""
        m = self.resolve_mesh(mesh)
        return int(m.shape[self.axis]) if m is not None else 1

    def active_on(self, mesh=None) -> bool:
        """Whether the policy applies on ``mesh`` (or its own / the
        Engine's)."""
        return self.resolve_mesh(mesh) is not None

    def kernel(self):
        """The per-rank attention function the config names."""
        if self.impl == "ulysses":
            from bigdl_tpu_torch.parallel.ulysses import ulysses_attention
            return ulysses_attention
        from bigdl_tpu_torch.parallel.ring_attention import ring_attention
        return ring_attention


_TLS = threading.local()


def active_sequence_parallel() -> Optional[SeqParallelConfig]:
    """The policy installed on this thread (None: dense)."""
    return getattr(_TLS, "config", None)


@contextlib.contextmanager
def use_sequence_parallel(
        config: Optional[SeqParallelConfig]
) -> Iterator[Optional[SeqParallelConfig]]:
    """Install ``config`` as this thread's policy for the block."""
    prev = getattr(_TLS, "config", None)
    _TLS.config = config
    try:
        yield config
    finally:
        _TLS.config = prev


def record_degree(degree: int) -> None:
    """Export the achieved degree (``train/seq_parallel/degree``)."""
    _G_DEGREE.set(int(degree))

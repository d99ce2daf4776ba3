"""The global batch behind a mesh step's slice of it (the JAX package
needs no counterpart: its SPMD program's arrays are global).

On a mesh each rank runs a slice of the global batch: its rows of the
data axis and, on a sequence axis, its consecutive positions. Two kinds
of layer look past the slice in the JAX package. Batch normalization in
training mode takes its statistics over the global batch, and a random
draw (a dropout mask, RReLU's slopes, a Gaussian sample) is one draw of
the global shape. The mesh step installs its rank's :class:`BatchSlice`
around the forward (:func:`use_batch_slice`), and those layers read it:

- :func:`sum_over_batch` sums a tensor over every rank the global batch
  spans: an autograd Function whose backward is the same sum, the
  adjoint, since every rank's loss is a part of the global objective;
- :func:`draw_rows` makes a draw of the global shape (every data rank's
  rows in rank order) and keeps this rank's rows, so each rank draws
  what the one-process run draws for its rows, and every rank's
  generator advances alike.

With no slice installed (one rank) both are the plain computation. A
draw on a sequence axis of more than one rank raises: which dim holds a
layer's positions is the layer's own.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import torch

from bigdl_tpu_torch.parallel import comm

__all__ = ["BatchSlice", "active_batch_slice", "draw_rows",
           "sum_over_batch", "use_batch_slice"]


@dataclass(frozen=True)
class BatchSlice:
    """A rank's part of the global batch: ``index`` of ``parts`` along
    the data axis, ``seq_parts`` ranks along the sequence axis, and the
    process groups (None for an axis of one rank) the batch spans."""
    index: int
    parts: int
    seq_parts: int = 1
    groups: Tuple = ()

    @property
    def ranks(self) -> int:
        return self.parts * self.seq_parts


_TLS = threading.local()


def active_batch_slice() -> Optional[BatchSlice]:
    """The slice installed on this thread (None off a mesh)."""
    return getattr(_TLS, "slice", None)


@contextlib.contextmanager
def use_batch_slice(part: Optional[BatchSlice]
                    ) -> Iterator[Optional[BatchSlice]]:
    """Install ``part`` as this thread's slice for the block."""
    prev = getattr(_TLS, "slice", None)
    _TLS.slice = part
    try:
        yield part
    finally:
        _TLS.slice = prev


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        out = x.clone()
        for g in groups:
            comm.all_reduce(out, g)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        for g in ctx.groups:
            comm.all_reduce(out, g)
        return out, None


def sum_over_batch(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the installed slice (``t`` itself
    with none)."""
    part = active_batch_slice()
    if part is None or not part.groups:
        return t
    return _SumOverRanks.apply(t, part.groups)


def draw_rows(shape, draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """``draw(shape)`` off a mesh; on one, this rank's rows of
    ``draw`` at the global shape (``shape[0]`` times the data ranks)."""
    shape = tuple(shape)
    part = active_batch_slice()
    if part is None or part.ranks == 1:
        return draw(shape)
    if part.seq_parts > 1:
        raise NotImplementedError(
            "a random draw (dropout, RReLU, a Gaussian sample) on a "
            "sequence axis of more than one rank is not ported yet "
            "(ROADMAP queue 1, item 11); train with dropout 0 there")
    rows = shape[0]
    full = draw((rows * part.parts,) + shape[1:])
    return full.narrow(0, part.index * rows, rows)

"""Sparse layers (counterpart of ``bigdl_tpu.nn.sparse``; BigDL
tensor/SparseTensor.scala, nn/SparseLinear.scala,
nn/SparseJoinTable.scala, nn/DenseToSparse.scala): the wide-and-deep
input path.

A sparse input is a ``torch.sparse_coo_tensor``, as
:meth:`~bigdl_tpu_torch.dataset.sample.HostBatchedCOO.to_sparse` builds
it from a batch: uncoalesced, padding entries at index 0 with value 0,
and a coordinate may repeat (the entries then sum, as ``to_dense()``
sums them). The weights stay dense: the data is what is sparse.

:class:`SparseLinear`'s product walks the COO's entries: each entry's
weight column gathered and scaled by its value, then summed into its
row with ``index_put_(accumulate=True)``. On the card both that sum and
the gather's backward (the weight gradient's scatter) sort the indices
and add each index's entries in their order (no atomics), so a run
repeats bitwise, and the entries of a row add in the order ``to_dense``
and the CPU add them. The JAX package's product is XLA's
``bcoo_dot_general``, not a Pallas kernel: this is a port of that
function, not of a TPU kernel.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table

__all__ = ["DenseToSparse", "SparseJoinTable", "SparseLinear",
           "sparse_dense_product", "to_sparse"]


def to_sparse(x, n_batch: int = 0) -> torch.Tensor:
    """Dense to a COO tensor of its nonzeros (DenseToSparse's
    semantics). ``n_batch`` is the JAX BCOO's count of dense leading
    dims; torch's COO has none, so every dim is sparse here and the
    values are the same."""
    return torch.as_tensor(x).to_sparse()


def _entries(x: torch.Tensor):
    """A COO tensor's ``(indices, values)`` as they stand (uncoalesced,
    the padding kept), or, for a sparse activation that carries a
    gradient (``DenseToSparse`` of a tensor that needs one), its
    coalesced entries, whose values pass the gradient on."""
    if x.requires_grad:
        x = x.coalesce()
        return x.indices(), x.values()
    return x._indices(), x._values()


def sparse_dense_product(x: torch.Tensor, weight: torch.Tensor):
    """``x @ weight.T`` for a COO ``x`` of shape ``[..., in]`` and a
    dense ``weight [out, in]``: ``[..., out]`` (the module docstring's
    gather and ordered sum)."""
    idx, vals = _entries(x)
    lead = tuple(x.shape[:-1])
    rows = torch.zeros_like(idx[0])
    for d, size in enumerate(lead):
        rows = rows * size + idx[d]
    contrib = vals[:, None].to(weight.dtype) * weight.t()[idx[-1]]
    n = 1
    for size in lead:
        n *= size
    out = torch.zeros((n, weight.shape[0]), dtype=contrib.dtype,
                      device=weight.device)
    out = out.index_put((rows,), contrib, accumulate=True)
    return out.reshape(lead + (weight.shape[0],))


class DenseToSparse(Module):
    """nn/DenseToSparse.scala: a dense activation as a COO tensor of its
    nonzeros; a sparse input passes untouched."""

    def forward(self, x):
        if isinstance(x, torch.Tensor) and x.is_sparse:
            return x
        return to_sparse(x)


class SparseLinear(Linear):
    """``y = x W^T + b`` with a sparse ``x`` (nn/SparseLinear.scala):
    Linear's parameters and initialization; a COO input goes through
    :func:`sparse_dense_product`, a dense one through Linear."""

    def forward(self, x):
        if not (isinstance(x, torch.Tensor) and x.is_sparse):
            return super().forward(x)
        out = sparse_dense_product(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out


class SparseJoinTable(Module):
    """The table's entries concatenated along ``dimension`` (1-based)
    as one COO tensor; dense entries are made sparse first
    (nn/SparseJoinTable.scala). The entries' indices are shifted and
    joined, so a gradient reaches the values of an entry that carries
    one (``torch.cat`` of sparse tensors has no backward)."""

    def __init__(self, dimension: int = 2):
        super().__init__()
        self.dimension = dimension

    def forward(self, table):
        items = list(table) if isinstance(table, (Table, list, tuple)) \
            else [table]
        axis = self.dimension - 1
        idx, vals, offset = [], [], 0
        for e in items:
            e = torch.as_tensor(e)
            i, v = _entries(e if e.is_sparse else to_sparse(e))
            shift = torch.zeros((i.shape[0], 1), dtype=i.dtype,
                                device=i.device)
            shift[axis] = offset
            idx.append(i + shift)
            vals.append(v)
            offset += e.shape[axis]
        shape = list(items[0].shape)
        shape[axis] = offset
        return torch.sparse_coo_tensor(torch.cat(idx, 1), torch.cat(vals),
                                       shape, check_invariants=False)

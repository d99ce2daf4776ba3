"""Samples and mini-batches (counterpart of
``bigdl_tpu.dataset.sample``; BigDL dataset/Sample.scala:32,
MiniBatch.scala:33).

A :class:`Sample` holds one record's features and labels as numpy
arrays, each one array or a list of arrays (multi-plane inputs such as
the packed ``[tokens, segment_ids, positions]``); a feature may also be
a :class:`SparseFeature` (one record's COO). :func:`samples_to_minibatch`
stacks records into a :class:`MiniBatch`: sparse features into a
:class:`HostBatchedCOO` whose nnz is padded to the batch's largest (or
a :class:`PaddingParam`'s fixed length) with index-0 / value-0 entries,
dense records of differing sizes padded to the largest under a
PaddingParam. Batches stay numpy on the host: the optimizer moves them
to the model's device (:func:`minibatch_input_to_device`; a
HostBatchedCOO becomes a ``torch.sparse_coo_tensor``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["HostBatchedCOO", "MiniBatch", "PaddingParam", "Sample",
           "SparseFeature", "minibatch_input_to_device",
           "samples_to_minibatch"]


class SparseFeature:
    """One record's sparse feature in host COO form (the per-record unit
    of the reference's SparseTensor path, tensor/SparseTensor.scala).

    ``indices``: ``[nnz, ndim]`` int32; ``values``: ``[nnz]``;
    ``shape``: the feature's dense shape (no batch dim)."""

    def __init__(self, indices, values, shape):
        self.values = np.asarray(values)
        self.shape = tuple(int(s) for s in shape)
        self.indices = np.asarray(indices, np.int32).reshape(
            len(self.values), len(self.shape))

    @classmethod
    def from_dense(cls, arr) -> "SparseFeature":
        arr = np.asarray(arr)
        idx = np.argwhere(arr != 0)
        return cls(idx, arr[tuple(idx.T)], arr.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, self.values.dtype)
        out[tuple(self.indices.T)] = self.values
        return out

    def __repr__(self):
        return (f"SparseFeature(nnz={len(self.values)}, "
                f"shape={self.shape})")


class HostBatchedCOO:
    """A batch of :class:`SparseFeature`s with one static shape: nnz
    padded to the batch's largest (or a PaddingParam's fixed length)
    with value-0 entries at index 0, which add nothing to a linear
    consumer (the host half of MiniBatch.scala:587's SparseMiniBatch).

    ``indices``: ``[B, max_nnz, ndim]``; ``values``: ``[B, max_nnz]``;
    ``shape``: ``(B, *dense_shape)``; ``fixed_nnz``: whether the nnz dim
    came from a PaddingParam's fixed length."""

    def __init__(self, indices, values, shape, fixed_nnz: bool = False):
        self.indices = indices
        self.values = values
        self.shape = tuple(shape)
        self.fixed_nnz = fixed_nnz

    def __getitem__(self, sl) -> "HostBatchedCOO":
        idx, vals = self.indices[sl], self.values[sl]
        return HostBatchedCOO(idx, vals, (len(vals),) + self.shape[1:],
                              self.fixed_nnz)

    def to_sparse(self, device=None) -> torch.Tensor:
        """The batch as a ``torch.sparse_coo_tensor`` of shape ``(B,
        *shape)`` on ``device`` (the JAX package's ``to_bcoo``):
        uncoalesced, entries in row order, the padding kept."""
        b, nnz, nd = self.indices.shape
        rows = np.repeat(np.arange(b, dtype=np.int64), nnz)
        idx = np.concatenate([rows[None], self.indices.reshape(
            b * nnz, nd).T.astype(np.int64)])
        return torch.sparse_coo_tensor(
            torch.from_numpy(idx), torch.from_numpy(
                np.ascontiguousarray(self.values.reshape(-1))),
            self.shape, device=device, check_invariants=False)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, self.values.dtype)
        b = np.repeat(np.arange(self.shape[0]), self.indices.shape[1])
        flat = self.indices.reshape(-1, self.indices.shape[-1])
        # the padding entries all add 0 at index 0
        np.add.at(out, (b,) + tuple(flat.T), self.values.ravel())
        return out


class Sample:
    """A feature/label pair; features and labels may each be one array
    or a list of arrays (``ArraySample`` in the reference); a feature
    may be a :class:`SparseFeature`."""

    def __init__(self, feature, label=None):
        self.features = [f if isinstance(f, SparseFeature)
                         else np.asarray(f) for f in
                         (feature if isinstance(feature, (list, tuple))
                          else [feature])]
        if label is None:
            self.labels = []
        else:
            self.labels = [np.asarray(l) for l in
                           (label if isinstance(label, (list, tuple))
                            else [label])]

    def __repr__(self):
        fs = ",".join(str(f.shape) for f in self.features)
        ls = ",".join(str(l.shape) for l in self.labels)
        return f"Sample(features=[{fs}], labels=[{ls}])"


class MiniBatch:
    """A stacked batch (dataset/MiniBatch.scala:110): ``input`` /
    ``target`` are numpy arrays or HostBatchedCOOs, or lists of them for
    multi-plane inputs."""

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def size(self) -> int:
        x = self.input[0] if isinstance(self.input, (list, tuple)) \
            else self.input
        return x.shape[0]

    def slice(self, offset: int, length: int) -> "MiniBatch":
        """Rows ``[offset, offset + length)``, 1-based as MiniBatch.slice
        in the reference (a sparse plane sliced by row)."""
        sl = slice(offset - 1, offset - 1 + length)

        def cut(x):
            if isinstance(x, (list, tuple)):
                return [xx[sl] for xx in x]
            return x[sl] if x is not None else None

        return MiniBatch(cut(self.input), cut(self.target))

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target


class PaddingParam:
    """Padding strategy (MiniBatch.scala:522-585): variable-size records
    padded to the batch's largest, or to ``fixed_length`` along their
    first dim (a sparse feature's nnz), with ``padding_value``."""

    def __init__(self, padding_value: float = 0.0,
                 fixed_length: Optional[int] = None):
        self.padding_value = padding_value
        self.fixed_length = fixed_length


def _stack_sparse(feats: List[SparseFeature],
                  padding: Optional[PaddingParam] = None) -> HostBatchedCOO:
    """SparseFeatures as one HostBatchedCOO (SparseMiniBatch.init,
    MiniBatch.scala:587): nnz padded to the batch's largest (or the
    PaddingParam's fixed length, which must hold it), at least 1, with
    index-0 / value-0 entries."""
    shape = feats[0].shape
    if any(f.shape != shape for f in feats):
        raise ValueError("sparse features in a batch must share a shape")
    max_nnz = max((len(f.values) for f in feats), default=0)
    fixed = padding is not None and padding.fixed_length is not None
    if fixed:
        if padding.fixed_length < max_nnz:
            raise ValueError(
                f"fixed nnz {padding.fixed_length} < batch max {max_nnz}")
        max_nnz = padding.fixed_length
    max_nnz = max(max_nnz, 1)
    b, nd = len(feats), len(shape)
    idx = np.zeros((b, max_nnz, nd), np.int32)
    vals = np.zeros((b, max_nnz), feats[0].values.dtype)
    for i, f in enumerate(feats):
        idx[i, :len(f.values)] = f.indices
        vals[i, :len(f.values)] = f.values
    return HostBatchedCOO(idx, vals, (b,) + shape, fixed_nnz=fixed)


def minibatch_input_to_device(inp, device=None):
    """A MiniBatch's input or target as the model takes it on
    ``device``: a HostBatchedCOO as a COO tensor, a list plane by plane,
    arrays as tensors (None stays None)."""
    if isinstance(inp, HostBatchedCOO):
        return inp.to_sparse(device)
    if isinstance(inp, (list, tuple)):
        return [minibatch_input_to_device(e, device) for e in inp]
    if inp is None:
        return None
    return torch.as_tensor(inp).to(device, non_blocking=True)


def _stack(arrays: list, padding: Optional[PaddingParam] = None):
    if isinstance(arrays[0], SparseFeature):
        return _stack_sparse(arrays, padding)
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1 and padding is None:
        return np.stack(arrays)
    # differing sizes: every dim padded to the largest (dim 0 to the
    # fixed length where that is longer)
    nd = arrays[0].ndim
    maxs = [max(a.shape[d] for a in arrays) for d in range(nd)]
    if padding is not None and padding.fixed_length is not None:
        maxs[0] = max(maxs[0], padding.fixed_length)
    val = padding.padding_value if padding is not None else 0.0
    out = np.full([len(arrays)] + maxs, val, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


def samples_to_minibatch(samples: Sequence[Sample],
                         feature_padding: Optional[PaddingParam] = None,
                         label_padding: Optional[PaddingParam] = None
                         ) -> MiniBatch:
    """Stack samples into one MiniBatch: one array (or HostBatchedCOO)
    per feature plane, a list when there are several, and likewise for
    labels (SampleToMiniBatch, dataset/Transformer.scala:309)."""
    n_feat = len(samples[0].features)
    n_lab = len(samples[0].labels)
    feats = [_stack([s.features[i] for s in samples], feature_padding)
             for i in range(n_feat)]
    labs = [_stack([s.labels[i] for s in samples], label_padding)
            for i in range(n_lab)]
    input = feats[0] if n_feat == 1 else feats
    target = None if n_lab == 0 else (labs[0] if n_lab == 1 else labs)
    return MiniBatch(input, target)

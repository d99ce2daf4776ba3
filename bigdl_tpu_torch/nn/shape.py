"""Shape, reduction and table-plumbing layers (counterpart of
``bigdl_tpu.nn.shape``; BigDL nn/{Reshape,View,Squeeze,Select,...}.scala).

Dimension arguments are 1-based, as in Torch and the JAX package, and a
negative index counts from the end where the JAX code lets it. A table
is a list, a tuple or a :class:`~bigdl_tpu_torch.utils.table.Table`
(read in its 1-based order); a layer that returns a table returns a
list, as the port's ``ConcatTable`` does.

``MaskedSelect`` returns the compacted vector, a size the data decides,
as the JAX package's eager path does. ``Nms`` returns the JAX package's
fixed ``[max_output]`` int32 vector of kept indices padded with -1; its
greedy pass over the boxes reads the overlap matrix on the host once.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.linear import CAdd, CMul
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table

__all__ = ["BifurcateSplitTable", "Contiguous", "FlattenTable", "Index",
           "InferReshape", "JoinTable", "MaskedSelect", "Max", "Mean", "Min",
           "Narrow", "Nms", "Pack", "Padding", "Replicate", "Reshape",
           "ResizeBilinear", "Reverse", "Scale", "Select", "SelectTable",
           "SpatialZeroPadding", "SplitTable", "Squeeze", "Sum", "Tile",
           "Transpose", "Unsqueeze", "View"]


def _shift(axis: int, ndim: int, n_input_dims: int) -> int:
    """``axis`` moved past the batch dims when the input has more than
    ``n_input_dims`` dims (the reference's ``nInputDims``)."""
    if n_input_dims > 0 and ndim > n_input_dims:
        axis += ndim - n_input_dims
    return axis


class Reshape(Module):
    """nn/Reshape.scala: reshape to ``size``. ``batch_mode=True`` keeps
    dim 0 as the batch; ``None`` keeps it only when the element count
    differs from ``size``'s; ``False`` never does."""

    def __init__(self, size: Sequence[int],
                 batch_mode: Optional[bool] = None):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        n = 1
        for s in self.size:
            n *= s
        batched = self.batch_mode is True or (
            self.batch_mode is None and x.numel() != n)
        if batched:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


class InferReshape(Module):
    """nn/InferReshape.scala: ``size`` may hold -1 (inferred) and 0
    (the input's size there); ``batch_mode`` keeps dim 0."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = tuple(in_shape[i] if s == 0 else s
                    for i, s in enumerate(self.size))
        if self.batch_mode:
            return x.reshape((x.shape[0],) + out)
        return x.reshape(out)


class View(Module):
    """nn/View.scala: reshape to ``sizes``, keeping the batch dimension
    when the input has more than ``num_input_dims`` dims (or when the
    element count does not match ``sizes`` alone)."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def forward(self, x):
        n = 1
        for s in self.sizes:
            n *= s
        if self.num_input_dims > 0 and x.ndim > self.num_input_dims:
            return x.reshape((x.shape[0],) + self.sizes)
        if x.numel() == n:
            return x.reshape(self.sizes)
        return x.reshape((x.shape[0],) + self.sizes)


class Squeeze(Module):
    """nn/Squeeze.scala: drop every size-1 dim, or ``dim`` (1-based,
    shifted by one under ``batch_mode``), which must have size 1 (as
    ``jnp.squeeze`` requires)."""

    def __init__(self, dim: Optional[int] = None, num_input_dims: int = 0,
                 batch_mode: bool = False):
        super().__init__()
        self.dim = dim
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.dim is None:
            return x.squeeze()
        axis = self.dim - 1 + (1 if self.batch_mode else 0)
        if x.shape[axis] != 1:
            raise ValueError(f"cannot squeeze dim {axis} of size "
                             f"{x.shape[axis]}")
        return x.squeeze(axis)


class Unsqueeze(Module):
    """nn/Unsqueeze.scala: a size-1 dim at ``pos`` (1-based), after the
    batch dims when the input has more than ``num_input_dims``."""

    def __init__(self, pos: int, num_input_dims: int = 0):
        super().__init__()
        self.pos = pos
        self.num_input_dims = num_input_dims

    def forward(self, x):
        return x.unsqueeze(_shift(self.pos - 1, x.ndim, self.num_input_dims))


class Transpose(Module):
    """nn/Transpose.scala: the ``(dim1, dim2)`` swaps (1-based) in
    order."""

    def __init__(self, permutations: Sequence[Sequence[int]]):
        super().__init__()
        self.permutations = [tuple(p) for p in permutations]

    def forward(self, x):
        for d1, d2 in self.permutations:
            x = x.transpose(d1 - 1, d2 - 1)
        return x


class Contiguous(Module):
    """nn/Contiguous.scala: the input in a contiguous layout (the same
    values)."""

    def forward(self, x):
        return x.contiguous()


class Replicate(Module):
    """nn/Replicate.scala: a new dim of ``n_features`` copies at
    ``dim`` (1-based)."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = 0):
        super().__init__()
        self.n_features = n_features
        self.dim = dim

    def forward(self, x):
        x = x.unsqueeze(self.dim - 1)
        reps = [1] * x.ndim
        reps[self.dim - 1] = self.n_features
        return x.repeat(reps)


class Padding(Module):
    """nn/Padding.scala: ``|pad|`` entries of ``value`` along ``dim``
    (1-based; one further for an input of more than ``n_input_dim``
    dims), before the data for a negative ``pad``, after it else."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim = dim
        self.pad = pad
        self.n_input_dim = n_input_dim
        self.value = value

    def forward(self, x):
        axis = self.dim - 1 + (1 if x.ndim > self.n_input_dim else 0)
        cfg = [0, 0] * (x.ndim - axis)
        # F.pad lists (before, after) from the last dim backwards
        at = 2 * (x.ndim - 1 - axis)
        cfg[at:at + 2] = (abs(self.pad), 0) if self.pad < 0 \
            else (0, self.pad)
        return F.pad(x, cfg, value=self.value)


class SpatialZeroPadding(Module):
    """nn/SpatialZeroPadding.scala: zeros around H and W of NCHW (or
    CHW); unset sides take ``pad_left``."""

    def __init__(self, pad_left: int, pad_right: int = None,
                 pad_top: int = None, pad_bottom: int = None):
        super().__init__()
        self.pl = pad_left
        self.pr = pad_right if pad_right is not None else pad_left
        self.pt = pad_top if pad_top is not None else pad_left
        self.pb = pad_bottom if pad_bottom is not None else pad_left

    def forward(self, x):
        return F.pad(x, (self.pl, self.pr, self.pt, self.pb))


class Narrow(Module):
    """nn/Narrow.scala: ``[offset, offset + length)`` along
    ``dimension`` (1-based); a negative offset counts from the end, a
    negative length leaves that many fewer than the rest."""

    def __init__(self, dimension: int, offset: int, length: int = 1):
        super().__init__()
        self.dimension = dimension
        self.offset = offset
        self.length = length

    def forward(self, x):
        axis = self.dimension - 1
        offset = self.offset
        if offset < 0:
            offset = x.shape[axis] + offset + 1
        length = self.length
        if length < 0:
            length = x.shape[axis] - offset + 1 + length + 1
        return x.narrow(axis, offset - 1, length)


class Select(Module):
    """nn/Select.scala: entry ``index`` along ``dimension``, which is
    dropped (1-based; a negative index counts from the end)."""

    def __init__(self, dimension: int, index: int):
        super().__init__()
        self.dimension = dimension
        self.index = index

    def forward(self, x):
        axis = self.dimension - 1
        idx = self.index - 1 if self.index > 0 \
            else x.shape[axis] + self.index
        return x.select(axis, idx)


class SelectTable(Module):
    """nn/SelectTable.scala: the table's ``index``-th entry (1-based; a
    negative index counts from the end). The entry passes untouched,
    whatever it is (a sparse tensor, a nested table)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, table):
        items = list(table)
        idx = self.index if self.index > 0 \
            else len(items) + self.index + 1
        return items[idx - 1]


class MaskedSelect(Module):
    """nn/MaskedSelect.scala: input ``(x, mask)``; the entries of ``x``
    where ``mask`` is set, as a vector in row-major order (its length
    is the mask's count)."""

    def forward(self, table):
        x, mask = list(table)[:2]
        x = torch.as_tensor(x)
        return x[torch.as_tensor(mask, device=x.device).bool()]


class Index(Module):
    """nn/Index.scala: input ``(x, indices)``; the 1-based ``indices``
    of ``x`` along ``dimension`` (index 0 reads the last entry, as the
    JAX ``take`` wraps -1)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, table):
        x, idx = list(table)[:2]
        x = torch.as_tensor(x)
        axis = self.dimension - 1
        i = torch.as_tensor(idx, device=x.device).long() - 1
        i = torch.where(i < 0, i + x.shape[axis], i)
        return x.index_select(axis, i.reshape(-1)).reshape(
            x.shape[:axis] + i.shape + x.shape[axis + 1:])


class Max(Module):
    """nn/Max.scala: the maximum over ``dim`` (1-based, after the batch
    dims when the input has more than ``num_input_dims``); the values
    only, and a tie shares the gradient equally (``jnp.max``'s rule)."""

    def __init__(self, dim: int = 1, num_input_dims: int = 0):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def _axis(self, x) -> int:
        return _shift(self.dim - 1, x.ndim, self.num_input_dims)

    def forward(self, x):
        return torch.amax(x, dim=self._axis(x))


class Min(Max):
    """nn/Min.scala: :class:`Max`'s minimum."""

    def forward(self, x):
        return torch.amin(x, dim=self._axis(x))


class Mean(Module):
    """nn/Mean.scala: the mean over ``dimension`` (1-based, shifted past
    the batch dims as :class:`Max`), the dim dropped unless
    ``squeeze=False``."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def forward(self, x):
        axis = _shift(self.dimension - 1, x.ndim, self.n_input_dims)
        return x.mean(dim=axis, keepdim=not self.squeeze)


class Sum(Module):
    """nn/Sum.scala: the sum over ``dimension`` (as :class:`Mean`),
    divided by its size under ``size_average``."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def forward(self, x):
        axis = _shift(self.dimension - 1, x.ndim, self.n_input_dims)
        out = x.sum(dim=axis, keepdim=not self.squeeze)
        if self.size_average:
            out = out / x.shape[axis]
        return out


class Scale(Module):
    """nn/Scale.scala: a :class:`~bigdl_tpu_torch.nn.linear.CMul` then
    a :class:`~bigdl_tpu_torch.nn.linear.CAdd` of ``size``, ``x *
    weight + bias`` broadcast over the input (the JAX tree ``{"cmul":
    {"weight"}, "cadd": {"bias"}}``). Parameters are built on the CPU
    from ``generator``, the weight first."""

    def __init__(self, size: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = tuple(size)
        self.cmul = CMul(size, generator)
        self.cadd = CAdd(size, generator)

    def forward(self, x):
        return self.cadd(self.cmul(x))


class Tile(Module):
    """nn/Tile.scala: ``copies`` copies along ``dim`` (1-based)."""

    def __init__(self, dim: int = 1, copies: int = 2):
        super().__init__()
        self.dim = dim
        self.copies = copies

    def forward(self, x):
        reps = [1] * x.ndim
        reps[self.dim - 1] = self.copies
        return x.repeat(reps)


class Pack(Module):
    """nn/Pack.scala: the table's entries stacked along a new dim
    ``dimension`` (1-based); a lone tensor is a table of one."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, table):
        items = list(table) if isinstance(table, (Table, list, tuple)) \
            else [table]
        return torch.stack([torch.as_tensor(e) for e in items],
                           dim=self.dimension - 1)


class Reverse(Module):
    """nn/Reverse.scala: the input flipped along ``dimension``
    (1-based)."""

    def __init__(self, dimension: int = 1, is_inplace: bool = False):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return x.flip(self.dimension - 1)


class SplitTable(Module):
    """nn/SplitTable.scala: the slices along ``dimension`` (1-based,
    shifted past the batch dims as :class:`Mean`; a negative axis
    counts from the end), each with that dim dropped, as a list."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, x):
        axis = _shift(self.dimension - 1, x.ndim, self.n_input_dims)
        if axis < 0:
            axis += x.ndim
        return list(x.unbind(axis))


class BifurcateSplitTable(Module):
    """nn/BifurcateSplitTable.scala: the two halves along ``dimension``
    (1-based; the second takes the odd one)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        axis = self.dimension - 1
        half = x.shape[axis] // 2
        return [x.narrow(axis, 0, half),
                x.narrow(axis, half, x.shape[axis] - half)]


class JoinTable(Module):
    """nn/JoinTable.scala: the table's entries concatenated along
    ``dimension`` (1-based, shifted past the batch dims when the first
    entry has more than ``n_input_dims`` dims)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, table):
        items = list(table)
        axis = _shift(self.dimension - 1, items[0].ndim, self.n_input_dims)
        return torch.cat(items, dim=axis)


class FlattenTable(Module):
    """nn/FlattenTable.scala: a nested table's leaves as one flat list,
    depth first."""

    def forward(self, table):
        out = []

        def walk(t):
            if isinstance(t, (Table, list, tuple)):
                for v in t:
                    walk(v)
            else:
                out.append(t)

        walk(table)
        return out


class ResizeBilinear(Module):
    """nn/ResizeBilinear.scala: NCHW resized to ``(output_height,
    output_width)`` by bilinear interpolation, the JAX package's sample
    grid (in float32) and blend."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False):
        super().__init__()
        self.output_height = output_height
        self.output_width = output_width
        self.align_corners = align_corners

    def forward(self, x):
        _, _, h, w = x.shape
        oh, ow = self.output_height, self.output_width
        f32 = dict(dtype=torch.float32, device=x.device)
        if self.align_corners and oh > 1 and ow > 1:
            ys = torch.linspace(0.0, h - 1, oh, **f32)
            xs = torch.linspace(0.0, w - 1, ow, **f32)
        else:
            ys = (torch.arange(oh, **f32) * (h / oh)).clamp(0, h - 1)
            xs = (torch.arange(ow, **f32) * (w / ow)).clamp(0, w - 1)
        y0, x0 = ys.floor().long(), xs.floor().long()
        y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
        wy = (ys - y0).to(x.dtype)[None, None, :, None]
        wx = (xs - x0).to(x.dtype)[None, None, None, :]

        def g(yy, xx):
            return x[:, :, yy, :][:, :, :, xx]

        return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
                + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)


class Nms(Module):
    """Non-maximum suppression (nn/Nms.scala): input ``(boxes [N, 4]
    as (x1, y1, x2, y2), scores [N])``; the kept boxes' indices, in
    descending score order (a stable sort, as ``jnp.argsort``), as an
    int32 ``[max_output]`` vector padded with -1. A box is dropped when
    a kept box of a higher score overlaps it by more than
    ``iou_threshold``."""

    def __init__(self, iou_threshold: float = 0.5, max_output: int = 100):
        super().__init__()
        self.iou_threshold = iou_threshold
        self.max_output = max_output

    def forward(self, table):
        boxes, scores = list(table)[:2]
        boxes, scores = torch.as_tensor(boxes), torch.as_tensor(scores)
        order = torch.argsort(-scores, stable=True)
        b = boxes[order]
        x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
        iw = (torch.minimum(x2[:, None], x2[None, :])
              - torch.maximum(x1[:, None], x1[None, :])).clamp(min=0)
        ih = (torch.minimum(y2[:, None], y2[None, :])
              - torch.maximum(y1[:, None], y1[None, :])).clamp(min=0)
        inter = iw * ih
        union = areas[:, None] + areas[None, :] - inter
        over = (inter / union.clamp(min=1e-9) > self.iou_threshold)
        # the greedy pass reads the overlap matrix on the host (one copy)
        over = over.cpu().numpy()
        n = over.shape[0]
        keep = np.ones(n, bool)
        for i in range(n):
            keep[i] = not np.any(over[i, :i] & keep[:i])
        kept = order.cpu().numpy()[keep][:self.max_output]
        out = np.full(self.max_output, -1, np.int32)
        out[:len(kept)] = kept
        return torch.from_numpy(out).to(boxes.device)

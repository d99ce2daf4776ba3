"""Linear-algebra layers (counterpart of ``bigdl_tpu.nn.linear``; BigDL
nn/{Linear,Bilinear,CMul,CAdd,MM,...}.scala).

Parameter names and layouts are the JAX package's (``Bilinear.weight``
``[out, in1, in2]``, ``Euclidean.weight`` ``[in, out]``, ``Mul.weight``
``[1]``), so a JAX tree loads by name. Parameters are built on the CPU
from ``generator``; move the module after. A table input is the port's
:class:`~bigdl_tpu_torch.utils.table.Table` or a plain list, its first
two entries read.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)
from bigdl_tpu_torch.nn.module import Module, weight_penalty

__all__ = ["Add", "AddConstant", "Bilinear", "CAdd", "CMul", "Cosine",
           "CosineDistance", "DotProduct", "Euclidean", "Linear", "MM",
           "MV", "Mul", "MulConstant", "PairwiseDistance"]


def _uniform(shape, stdv: float, generator):
    """``U(-stdv, stdv)`` of ``shape`` in the default dtype."""
    return nn.Parameter(RandomUniform(-stdv, stdv)(tuple(shape), 1, 1,
                                                   generator))


def _pair(input):
    """The first two entries of a table input (a Table or a list)."""
    a, b = list(input)[:2]
    return a, b


def _unit_rows(x):
    """``x`` over its last axis's L2 norm, the norm clipped at 1e-12."""
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp(min=1e-12)


class Linear(Module):
    """Fully-connected layer ``y = x W^T + b`` (nn/Linear.scala). The
    weight is stored ``[out, in]`` as in Torch and the JAX package;
    both default to ``U(-1/sqrt(in), 1/sqrt(in))``. ``w_regularizer`` /
    ``b_regularizer`` (:mod:`bigdl_tpu_torch.optim.regularizer`) add
    their penalties to :meth:`regularization_loss`. Parameters are
    built on the CPU from ``generator``; move the module after."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        w_init = init_weight or RandomUniform()
        b_init = init_bias or RandomUniform()
        self.weight = nn.Parameter(w_init((output_size, input_size),
                                          input_size, output_size,
                                          generator))
        self.bias = nn.Parameter(b_init((output_size,), input_size,
                                        output_size, generator)) \
            if with_bias else None

    def forward(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        y = x @ self.weight.T
        if self.bias is not None:
            y = y + self.bias
        return y[0] if squeeze else y

    def regularization_loss(self):
        return weight_penalty(self)


class MulConstant(Module):
    """``x * scalar`` (nn/MulConstant.scala; ``ip`` is accepted and
    ignored, as in the JAX package)."""

    def __init__(self, scalar: float, ip: bool = False):
        super().__init__()
        self.scalar = scalar

    def forward(self, x):
        return x * self.scalar


class AddConstant(Module):
    """``x + scalar`` (nn/AddConstant.scala; ``ip`` is accepted and
    ignored, as in the JAX package)."""

    def __init__(self, constant_scalar: float, ip: bool = False):
        super().__init__()
        self.constant_scalar = constant_scalar

    def forward(self, x):
        return x + self.constant_scalar


class Bilinear(Module):
    """``y_k = x1^T W_k x2 + b_k`` over a table input ``(x1 [B, in1],
    x2 [B, in2])`` (nn/Bilinear.scala). Weight ``[out, in1, in2]`` and
    bias (with ``bias_res``) are ``U(-1/sqrt(in1), 1/sqrt(in1))``, drawn
    in that order; ``w_regularizer`` / ``b_regularizer`` add their
    penalties to :meth:`regularization_loss`."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, w_regularizer=None,
                 b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        stdv = 1.0 / math.sqrt(input_size1)
        self.weight = _uniform((output_size, input_size1, input_size2),
                               stdv, generator)
        self.bias = _uniform((output_size,), stdv, generator) \
            if bias_res else None

    def forward(self, input):
        x1, x2 = _pair(input)
        y = torch.einsum("bi,kij,bj->bk", x1, self.weight, x2)
        if self.bias is not None:
            y = y + self.bias
        return y

    def regularization_loss(self):
        return weight_penalty(self)


class CMul(Module):
    """A learned ``size``-shaped scale broadcast over the input
    (nn/CMul.scala): ``x * weight``, the weight ``U(-1/sqrt(n),
    1/sqrt(n))`` with ``n`` its element count."""

    def __init__(self, size: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = tuple(size)
        self.weight = _uniform(self.size, 1.0 / math.sqrt(
            math.prod(self.size)), generator)

    def forward(self, x):
        return x * self.weight


class CAdd(Module):
    """A learned ``size``-shaped bias broadcast over the input
    (nn/CAdd.scala): ``x + bias``, drawn as :class:`CMul`'s weight."""

    def __init__(self, size: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = tuple(size)
        self.bias = _uniform(self.size, 1.0 / math.sqrt(
            math.prod(self.size)), generator)

    def forward(self, x):
        return x + self.bias


class Mul(Module):
    """One learned scalar gain (nn/Mul.scala): ``x * weight[0]``, the
    weight ``[1]`` drawn ``U(-1, 1)``."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _uniform((1,), 1.0, generator)

    def forward(self, x):
        return x * self.weight[0]


class Add(Module):
    """A learned bias of ``input_size`` (nn/Add.scala), ``U(-1/sqrt(
    input_size), 1/sqrt(input_size))``."""

    def __init__(self, input_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.bias = _uniform((input_size,), 1.0 / math.sqrt(input_size),
                             generator)

    def forward(self, x):
        return x + self.bias


class MM(Module):
    """The (batched) matrix product of a table ``(a, b)`` (nn/MM.scala),
    either side transposed first (its last two axes)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a = trans_a
        self.trans_b = trans_b

    def forward(self, input):
        a, b = _pair(input)
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """The (batched) matrix-vector product of a table ``(m, v)``
    (nn/MV.scala), ``m`` transposed first with ``trans``."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, input):
        m, v = _pair(input)
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class Cosine(Module):
    """The cosine similarity of each row to each of ``output_size``
    learned anchors (nn/Cosine.scala): rows and anchors over their L2
    norms (clipped at 1e-12), then their product. Weight ``[out, in]``,
    ``U(-1/sqrt(in), 1/sqrt(in))``."""

    def __init__(self, input_size: int, output_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.weight = _uniform((output_size, input_size),
                               1.0 / math.sqrt(input_size), generator)

    def forward(self, x):
        return _unit_rows(x) @ _unit_rows(self.weight).T


class Euclidean(Module):
    """The L2 distance of each row to each of ``output_size`` learned
    centres (nn/Euclidean.scala). Weight ``[in, out]``, ``U(-1/sqrt(in),
    1/sqrt(in))``. The differences are taken whole, ``[B, in, out]``, as
    the JAX package takes them (a 1-D input gives ``[1, out]``);
    ``fast_backward`` is accepted and ignored, as there."""

    def __init__(self, input_size: int, output_size: int,
                 fast_backward: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.weight = _uniform((input_size, output_size),
                               1.0 / math.sqrt(input_size), generator)

    def forward(self, x):
        diff = x[..., :, None] - self.weight[None, :, :]
        return torch.linalg.vector_norm(diff, dim=-2)


class DotProduct(Module):
    """The row-wise dot product of a table ``(a, b)``
    (nn/DotProduct.scala)."""

    def forward(self, input):
        a, b = _pair(input)
        return (a * b).sum(dim=-1)


class PairwiseDistance(Module):
    """The row-wise Lp distance of a table ``(a, b)``
    (nn/PairwiseDistance.scala): ``sum(|a - b| ** norm) ** (1 /
    norm)``."""

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def forward(self, input):
        a, b = _pair(input)
        d = (a - b).abs()
        return d.pow(self.norm).sum(dim=-1).pow(1.0 / self.norm)


class CosineDistance(Module):
    """The row-wise cosine similarity of a table ``(a, b)``
    (nn/CosineDistance.scala), each norm clipped at 1e-12."""

    def forward(self, input):
        a, b = _pair(input)
        na = torch.linalg.vector_norm(a, dim=-1).clamp(min=1e-12)
        nb = torch.linalg.vector_norm(b, dim=-1).clamp(min=1e-12)
        return (a * b).sum(dim=-1) / (na * nb)

"""Activations (counterpart of ``bigdl_tpu.nn.activation``; BigDL
nn/{ReLU,Tanh,Sigmoid,...}.scala): the whole file.

Elementwise maps written as the JAX package writes them, op for op, so
the two agree to float32 rounding in value and in gradient (a
``where`` here is a ``jnp.where`` there). ``PReLU`` owns a parameter;
``RReLU`` in training mode and ``GaussianSampler`` draw from an explicit
``torch.Generator`` (None: torch's default generator of the input's
device), so their draws are not the JAX package's; ``GradientReversal``
is a ``torch.autograd.Function``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.parallel.global_batch import draw_rows
from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["Abs", "BinaryThreshold", "Clamp", "ELU", "Echo", "Exp",
           "GaussianSampler", "GradientReversal", "HardShrink",
           "HardSigmoid", "HardTanh", "Identity", "LeakyReLU", "Log",
           "Log1p", "LogSigmoid", "LogSoftMax", "Negative", "PReLU", "Power",
           "RReLU", "ReLU", "ReLU6", "Sigmoid", "SoftMax", "SoftMin",
           "SoftPlus", "SoftShrink", "SoftSign", "Sqrt", "Square", "Tanh",
           "TanhShrink", "Threshold"]


class _Elementwise(Module):
    def op(self, x):
        raise NotImplementedError

    def forward(self, x):
        return self.op(x)


def _feature_dim(x) -> int:
    """Torch's softmax dim: the last for 1-/2-D input, 1 for a batch of
    maps."""
    return -1 if x.ndim <= 2 else 1


class ReLU(_Elementwise):
    """nn/ReLU.scala (the ``ip`` flag is accepted and ignored, as in the
    JAX package)."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def op(self, x):
        return F.relu(x)


class ReLU6(_Elementwise):
    """nn/ReLU6.scala"""

    def op(self, x):
        return x.clamp(0.0, 6.0)


class Tanh(_Elementwise):
    def op(self, x):
        return torch.tanh(x)


class TanhShrink(_Elementwise):
    """nn/TanhShrink.scala: x - tanh(x)"""

    def op(self, x):
        return x - torch.tanh(x)


class Sigmoid(_Elementwise):
    def op(self, x):
        return torch.sigmoid(x)


class LogSigmoid(_Elementwise):
    def op(self, x):
        return F.logsigmoid(x)


class SoftMax(_Elementwise):
    """nn/SoftMax.scala: softmax over the feature dim."""

    def op(self, x):
        return torch.softmax(x, dim=_feature_dim(x))


class SoftMin(_Elementwise):
    """nn/SoftMin.scala: softmax of -x"""

    def op(self, x):
        return torch.softmax(-x, dim=_feature_dim(x))


class LogSoftMax(_Elementwise):
    """nn/LogSoftMax.scala:21, over the last dim."""

    def op(self, x):
        return torch.log_softmax(x, dim=-1)


class SoftPlus(_Elementwise):
    """nn/SoftPlus.scala: 1/beta * log(1 + exp(beta x))"""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def op(self, x):
        # jax.nn.softplus is logaddexp(x, 0), with no linear cut-off
        return torch.logaddexp(self.beta * x, torch.zeros_like(x)) / self.beta


class SoftSign(_Elementwise):
    def op(self, x):
        return x / (1.0 + x.abs())


class ELU(_Elementwise):
    def __init__(self, alpha: float = 1.0, ip: bool = False):
        super().__init__()
        self.alpha = alpha

    def op(self, x):
        return torch.where(x > 0, x, self.alpha * torch.expm1(x))


class LeakyReLU(_Elementwise):
    def __init__(self, negval: float = 0.01, ip: bool = False):
        super().__init__()
        self.negval = negval

    def op(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class PReLU(Module):
    """nn/PReLU.scala: learnable per-channel slope (``n_output_plane=0``
    is one shared slope), initialised to 0.25."""

    def __init__(self, n_output_plane: int = 0):
        super().__init__()
        self.n_output_plane = n_output_plane
        self.weight = nn.Parameter(torch.full(
            (max(1, n_output_plane),), 0.25, dtype=default_dtype()))

    def forward(self, x):
        w = self.weight
        if self.n_output_plane > 0 and x.ndim > 1:
            shape = [1] * x.ndim
            shape[1] = self.n_output_plane
            w = w.reshape(shape)
        return torch.where(x >= 0, x, w * x)


class RReLU(Module):
    """nn/RReLU.scala: randomized leaky ReLU. In training mode each
    negative element's slope is drawn from ``U[lower, upper)`` with
    ``generator``; in evaluation mode the slope is their mean."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 ip: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lower = lower
        self.upper = upper
        self.generator = generator

    def forward(self, x):
        if self.training:
            a = draw_rows(x.shape, lambda s: torch.empty(
                s, dtype=x.dtype, device=x.device).uniform_(
                    self.lower, self.upper, generator=self.generator))
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class SoftShrink(_Elementwise):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def op(self, x):
        zero = torch.zeros_like(x)
        return torch.where(x > self.lambd, x - self.lambd,
                           torch.where(x < -self.lambd, x + self.lambd, zero))


class HardShrink(_Elementwise):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def op(self, x):
        return torch.where(x.abs() > self.lambd, x, torch.zeros_like(x))


class HardTanh(_Elementwise):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 ip: bool = False):
        super().__init__()
        self.min_value = min_value
        self.max_value = max_value

    def op(self, x):
        return x.clamp(self.min_value, self.max_value)


class HardSigmoid(_Elementwise):
    def op(self, x):
        return (0.2 * x + 0.5).clamp(0.0, 1.0)


class Threshold(_Elementwise):
    """nn/Threshold.scala: x if x > th else v"""

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th = th
        self.v = v

    def op(self, x):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class BinaryThreshold(_Elementwise):
    """nn/BinaryThreshold.scala: 1 if x > th else 0 (no gradient)."""

    def __init__(self, th: float = 1e-6, ip: bool = False):
        super().__init__()
        self.th = th

    def op(self, x):
        return (x > self.th).to(x.dtype)


class Clamp(HardTanh):
    """nn/Clamp.scala"""

    def __init__(self, min_value: float, max_value: float):
        super().__init__(min_value, max_value)


class Power(_Elementwise):
    """nn/Power.scala: (shift + scale * x) ^ power"""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power = power
        self.scale = scale
        self.shift = shift

    def op(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Square(_Elementwise):
    def op(self, x):
        return x * x


class Sqrt(_Elementwise):
    def op(self, x):
        return torch.sqrt(x)


class Log(_Elementwise):
    def op(self, x):
        return torch.log(x)


class Log1p(_Elementwise):
    def op(self, x):
        return torch.log1p(x)


class Exp(_Elementwise):
    def op(self, x):
        return torch.exp(x)


class Abs(_Elementwise):
    def op(self, x):
        return x.abs()


class Negative(_Elementwise):
    def op(self, x):
        return -x


class Identity(_Elementwise):
    """nn/Identity.scala"""

    def op(self, x):
        return x


class Echo(Module):
    """nn/Echo.scala: identity that prints the input's shape."""

    def forward(self, x):
        print(f"Echo: shape {tuple(getattr(x, 'shape', ()))}")
        return x


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(Module):
    """nn/GradientReversal.scala: identity forward, ``-lambda * grad``
    backward (domain-adversarial training)."""

    def __init__(self, the_lambda: float = 1.0):
        super().__init__()
        self.the_lambda = the_lambda

    def forward(self, x):
        return _Reverse.apply(x, self.the_lambda)


class GaussianSampler(Module):
    """nn/GaussianSampler.scala: the VAE's reparameterised sample
    ``mean + exp(0.5 * log_var) * eps`` from the table ``(mean,
    log_var)``, ``eps ~ N(0, 1)`` drawn with ``generator``."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.generator = generator

    def forward(self, x):
        mean, log_var = list(x)[:2]
        eps = draw_rows(mean.shape, lambda s: torch.empty(
            s, dtype=mean.dtype, device=mean.device).normal_(
                generator=self.generator))
        return mean + torch.exp(0.5 * log_var) * eps

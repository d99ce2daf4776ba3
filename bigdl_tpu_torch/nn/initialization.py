"""Parameter initialization methods (counterpart of
``bigdl_tpu.nn.initialization``; BigDL nn/InitializationMethod.scala).

Each method is a callable ``(shape, fan_in, fan_out, generator) ->
tensor`` in the port's default dtype on the CPU: the JAX package's
``(rng, shape, fan_in, fan_out, dtype)`` with its key replaced by an
explicit ``torch.Generator`` (None: torch's global generator). The two
packages draw different numbers from one seed, with the same
distributions.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["BilinearFiller", "ConstInitMethod", "InitializationMethod",
           "MsraFiller", "Ones", "RandomNormal", "RandomUniform", "Xavier",
           "Zeros"]


class InitializationMethod:
    """Weight-init contract: ``init(shape, fan_in, fan_out,
    generator)``."""

    def __call__(self, shape: Sequence[int], fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator] = None):
        raise NotImplementedError


class Zeros(InitializationMethod):
    """InitializationMethod.scala:221"""

    def __call__(self, shape, fan_in, fan_out, generator=None):
        return torch.zeros(tuple(shape), dtype=default_dtype())


class Ones(InitializationMethod):
    """InitializationMethod.scala:233"""

    def __call__(self, shape, fan_in, fan_out, generator=None):
        return torch.ones(tuple(shape), dtype=default_dtype())


class ConstInitMethod(InitializationMethod):
    """InitializationMethod.scala:244"""

    def __init__(self, value: float):
        self.value = value

    def __call__(self, shape, fan_in, fan_out, generator=None):
        return torch.full(tuple(shape), self.value, dtype=default_dtype())


class RandomUniform(InitializationMethod):
    """InitializationMethod.scala:178,196 — with no bounds, the Torch
    default ``1/sqrt(fan_in)`` bound (the ``reset()`` convention of
    Linear / conv)."""

    def __init__(self, lower: Optional[float] = None,
                 upper: Optional[float] = None):
        self.lower = lower
        self.upper = upper

    def __call__(self, shape, fan_in, fan_out, generator=None):
        if self.lower is None:
            stdv = 1.0 / math.sqrt(max(1, fan_in))
            lo, hi = -stdv, stdv
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(tuple(shape), dtype=default_dtype()).uniform_(
            lo, hi, generator=generator)


class RandomNormal(InitializationMethod):
    """InitializationMethod.scala:209: ``mean + stdv * N(0, 1)``."""

    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean = mean
        self.stdv = stdv

    def __call__(self, shape, fan_in, fan_out, generator=None):
        return self.mean + self.stdv * torch.randn(
            tuple(shape), dtype=default_dtype(), generator=generator)


class Xavier(InitializationMethod):
    """Glorot uniform (InitializationMethod.scala:272): ``U(-b, b)``,
    ``b = sqrt(6 / (fan_in + fan_out))``."""

    def __call__(self, shape, fan_in, fan_out, generator=None):
        stdv = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(tuple(shape), dtype=default_dtype()).uniform_(
            -stdv, stdv, generator=generator)


class MsraFiller(InitializationMethod):
    """Kaiming/MSRA normal (InitializationMethod.scala:297): std
    ``sqrt(2 / n)``, ``n`` the fan-in, or the fan-out with
    ``var_in_count=False``."""

    def __init__(self, var_in_count: bool = True):
        self.var_in_count = var_in_count

    def __call__(self, shape, fan_in, fan_out, generator=None):
        n = fan_in if self.var_in_count else fan_out
        std = math.sqrt(2.0 / max(1, n))
        return std * torch.randn(tuple(shape), dtype=default_dtype(),
                                 generator=generator)


class BilinearFiller(InitializationMethod):
    """Bilinear-upsampling kernel for a deconvolution's 4-D ``(out, in,
    kh, kw)`` weight (InitializationMethod.scala:321), every ``(out,
    in)`` plane the same filter, computed as the JAX package computes
    it."""

    def __call__(self, shape, fan_in, fan_out, generator=None):
        if len(shape) != 4:
            raise ValueError(f"BilinearFiller expects a 4-D weight, got "
                             f"{tuple(shape)}")
        dt = default_dtype()
        kh, kw = shape[2], shape[3]
        f = math.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(kh * kw, dtype=dt)
        x = i % kw
        y = torch.div(i, kw, rounding_mode="floor") % kh
        filt = (1 - torch.abs(x / f - c)) * (1 - torch.abs(y / f - c))
        return filt.reshape(1, 1, kh, kw).expand(tuple(shape)).clone()

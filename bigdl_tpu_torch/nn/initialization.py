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

__all__ = ["InitializationMethod", "MsraFiller", "Ones", "RandomUniform",
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

"""Dropout and penalties (counterpart of ``bigdl_tpu.nn.dropout``; BigDL
nn/Dropout.scala, nn/SpatialDropout2D.scala, nn/L1Penalty.scala).

The JAX package draws its masks from an explicit ``rng`` key; the port
draws them from a ``torch.Generator`` the caller passes to ``forward``
(the train step owns one on the module's device). Every keep mask of the
port, the attention's included, comes from :func:`keep_mask`, the one
draw site.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.parallel.global_batch import draw_rows

__all__ = ["Dropout", "L1Penalty", "SpatialDropout2D", "keep_mask"]


def keep_mask(shape, p: float, generator: torch.Generator) -> torch.Tensor:
    """A boolean mask of ``shape`` on ``generator``'s device, each
    element True with probability ``1 - p`` (``jax.random.bernoulli(rng,
    1 - p, shape)``: a uniform draw below ``1 - p``). In a mesh step,
    this rank's rows of the global batch's mask
    (:func:`~bigdl_tpu_torch.parallel.global_batch.draw_rows`)."""
    u = draw_rows(shape, lambda s: torch.rand(s, generator=generator,
                                              device=generator.device))
    return u < (1.0 - p)


def _needs_generator(name: str, generator) -> None:
    if generator is None:
        raise ValueError(f"{name} in training mode requires a generator")


class Dropout(Module):
    """nn/Dropout.scala: inverted dropout by default (``scale=True``).
    Training: ``where(keep, x, 0) / (1 - p)`` (no division with
    ``scale=False``); evaluation: the identity, or ``x * (1 - p)`` with
    ``scale=False``. ``inplace`` is accepted for the reference's
    signature and changes nothing."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = init_p
        self.scale = scale

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p <= 0.0:
            if not self.training and not self.scale:
                return x * (1.0 - self.p)
            return x
        _needs_generator("Dropout", generator)
        y = torch.where(keep_mask(x.shape, self.p, generator), x, 0.0)
        if self.scale:
            y = y / (1.0 - self.p)
        return y


class SpatialDropout2D(Module):
    """Channel-wise dropout for NCHW maps: one keep draw per (N, C),
    ``where(keep, x / (1 - p), 0)`` in training, the identity in
    evaluation."""

    def __init__(self, init_p: float = 0.5):
        super().__init__()
        self.p = init_p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p <= 0.0:
            return x
        _needs_generator("SpatialDropout2D", generator)
        shape = (x.shape[0], x.shape[1]) + (1,) * (x.ndim - 2)
        return torch.where(keep_mask(shape, self.p, generator),
                           x / (1.0 - self.p), 0.0)


class _L1(torch.autograd.Function):
    """Identity forward; ``g + lam * sign(x)`` backward."""

    @staticmethod
    def forward(ctx, x, lam: float):
        ctx.save_for_backward(x)
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.lam * torch.sign(x), None


class L1Penalty(Module):
    """nn/L1Penalty.scala: the identity forward, whose backward adds
    ``l1weight * sign(x)`` to the incoming gradient (``l1weight /
    numel`` with ``size_average``): the gradient of an L1 penalty on the
    activations. Active in training mode only. ``provide_output`` is
    accepted for the reference's signature."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = float(l1weight)
        self.size_average = size_average

    def forward(self, x):
        if not self.training:
            return x
        lam = self.l1weight / x.numel() if self.size_average \
            else self.l1weight
        return _L1.apply(x, lam)

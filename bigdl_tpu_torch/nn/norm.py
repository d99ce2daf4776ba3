"""Normalization layers (counterpart of ``bigdl_tpu.nn.norm``): batch,
layer and RMS normalization, Lp normalization, the two local response
normalizations of AlexNet and GoogLeNet, and the subtractive, divisive
and contrastive local normalizations of the early Torch image nets."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.initialization import InitializationMethod
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.parallel.global_batch import (active_batch_slice,
                                                   sum_over_batch)
from bigdl_tpu_torch.utils.engine import default_dtype, full_float32

__all__ = ["BatchNormalization", "LayerNorm", "Normalize", "RMSNorm",
           "SpatialBatchNormalization", "SpatialContrastiveNormalization",
           "SpatialCrossMapLRN", "SpatialDivisiveNormalization",
           "SpatialSubtractiveNormalization", "SpatialWithinChannelLRN"]


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a float64 dtype keeps it whole)."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


class LayerNorm(Module):
    """Layer normalization over the last dim.

    Statistics are taken in float32 with the population variance; the
    normalized value is cast back to the input dtype *before* the
    affine, so activations stay in their compute dtype (the JAX
    package's order, kept so the two agree in bf16 too)."""

    def __init__(self, hidden_size: int, eps: float = 1e-5):
        super().__init__()
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, dtype=default_dtype()))
        self.bias = nn.Parameter(
            torch.zeros(hidden_size, dtype=default_dtype()))

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = ((x32 - mu) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return y * self.weight + self.bias


class RMSNorm(Module):
    """RMS normalization (LLaMA-style) over the last dim: the mean
    square accumulates in float32, ``inv = rsqrt(ms + eps)`` is cast
    back to the input dtype, then ``x * inv * weight`` (the JAX
    package's order). The weight starts at ones."""

    def __init__(self, hidden_size: int, eps: float = 1e-6):
        super().__init__()
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, dtype=default_dtype()))

    def forward(self, x):
        ms = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(ms + self.eps).to(x.dtype)
        return x * inv * self.weight


class BatchNormalization(Module):
    """Batch norm over ``(B, F)`` (nn/BatchNormalization.scala), and over
    ``(B, C, H, W)`` as :class:`SpatialBatchNormalization` — the same
    code: the feature axis is 1 (0 for a 1-D input).

    The JAX package's state ``{running_mean, running_var}`` is a pair of
    buffers here. Both modes normalize in the JAX package's order:
    ``(x - mean) * rsqrt(var + eps)``, then ``* weight + bias``.
    Evaluation mode takes the running statistics. Training mode takes
    the batch's, computed as the JAX package computes them: one pass in
    float32 (a float64 input in float64), ``var = max(E[x^2] - E[x]^2,
    0)`` (the biased variance normalizes), and updates the buffers in
    place, outside autograd:
    ``running = (1 - momentum) * running + momentum * batch``, the
    variance times the Bessel factor ``n / max(n - 1, 1)``. (Not
    ``F.batch_norm``: its two-pass variance rounds otherwise.) In a
    mesh step the batch is the global one: the sums of ``x`` and
    ``x^2`` are summed over the ranks
    (:func:`~bigdl_tpu_torch.parallel.global_batch.sum_over_batch`) and
    ``n`` counts every rank's rows, so every rank normalizes alike and
    keeps equal buffers. The
    weight defaults to ``U(0, 1)`` and the bias to zeros, as in the
    reference's ``reset()``; parameters are built on the CPU from
    ``generator``."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        dt = default_dtype()
        if affine:
            w = (init_weight((n_output,), n_output, n_output, generator)
                 if init_weight is not None else
                 torch.rand((n_output,), dtype=dt, generator=generator))
            b = (init_bias((n_output,), n_output, n_output, generator)
                 if init_bias is not None else
                 torch.zeros((n_output,), dtype=dt))
            self.weight = nn.Parameter(w)
            self.bias = nn.Parameter(b)
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean",
                             torch.zeros((n_output,), dtype=dt))
        self.register_buffer("running_var", torch.ones((n_output,), dtype=dt))

    def _reshape(self, v, ndim: int):
        shape = [1] * ndim
        shape[1 if ndim > 1 else 0] = self.n_output
        return v.reshape(shape)

    def _batch_statistics(self, x):
        """The batch's mean and biased variance in ``x``'s dtype, and the
        running buffers updated in place (the JAX package's op
        sequence)."""
        ndim = x.ndim
        axes = tuple(i for i in range(ndim) if i != (1 if ndim > 1 else 0))
        # float32 statistics, as the JAX package's; a float64 input keeps
        # float64, so a float64 run is float64 throughout
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        n = x.numel() // self.n_output
        part = active_batch_slice()
        if part is None:
            mean32 = x32.mean(dim=axes)
            ex2 = x32.square().mean(dim=axes)
        else:
            # on a mesh, the global batch's: the sums over every rank
            n *= part.ranks
            sums = sum_over_batch(torch.stack(
                [x32.sum(dim=axes), x32.square().sum(dim=axes)]))
            mean32, ex2 = sums[0] / n, sums[1] / n
        var32 = torch.clamp(ex2 - mean32.square(), min=0.0)
        mean, var = mean32.to(x.dtype), var32.to(x.dtype)
        # float32 division, as JAX's, then rounded to the statistics'
        # dtype as the JAX package casts its factor; the momentum is
        # rounded so too (a Python float meeting a bfloat16 array). The
        # running update itself is a float32 island: the bfloat16
        # statistics under a precision policy are widened to the
        # buffers' dtype before they are blended (the JAX package's
        # XLA keeps that product in float32, feeding a float32 sum)
        factor = _in_dtype(float(np.float32(n) / np.float32(max(n - 1, 1))),
                           var.dtype)
        m = self.momentum
        acc = self.running_mean.dtype
        with torch.no_grad():
            self.running_mean.copy_(
                (1 - m) * self.running_mean
                + _in_dtype(m, mean.dtype) * mean.detach().to(acc))
            self.running_var.copy_(
                (1 - m) * self.running_var
                + _in_dtype(m, var.dtype) * (var.detach().to(acc) * factor))
        return mean, var

    def forward(self, x):
        ndim = x.ndim
        if self.training:
            mean, var = self._batch_statistics(x)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = (x - self._reshape(mean, ndim)) * self._reshape(inv, ndim)
        if self.affine:
            y = y * self._reshape(self.weight, ndim) \
                + self._reshape(self.bias, ndim)
        return y


class SpatialBatchNormalization(BatchNormalization):
    """BN over ``(B, C, H, W)`` (nn/SpatialBatchNormalization.scala) —
    the same code: the reduction axes follow the input's rank."""


def _window_sum(x, dim: int, size: int):
    """Sums over windows of ``size`` along ``dim``, the input padded with
    zeros ``(size - 1) // 2`` in front and the rest behind (the JAX
    package's ``reduce_window`` padding): the same length as ``x``.
    Shifted slices added in turn, so the backward is plain slicing and
    adds (deterministic on the card; ``avg_pool3d``'s backward is not)."""
    front = (size - 1) // 2
    pads = [0, 0] * (x.ndim - 1 - dim) + [front, size - 1 - front]
    padded = F.pad(x, pads)
    n = x.shape[dim]
    out = padded.narrow(dim, 0, n)
    for j in range(1, size):
        out = out + padded.narrow(dim, j, n)
    return out


class SpatialCrossMapLRN(Module):
    """AlexNet-style local response normalization across channels
    (nn/SpatialCrossMapLRN.scala) over NCHW: ``y = x / (k + alpha / size
    * sum x^2) ** beta``, the sum over a window of ``size`` channels
    padded ``(size - 1) // 2`` in front and ``size - 1 - (size - 1) //
    2`` behind, as the JAX package pads it (``F.local_response_norm``
    pads ``size // 2`` in front, another window for an even ``size``)."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, k: float = 1.0):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x):
        summed = _window_sum(x * x, 1, self.size)
        denom = torch.pow(self.k + self.alpha / self.size * summed,
                          self.beta)
        return x / denom


class SpatialWithinChannelLRN(Module):
    """Local response normalization within each channel over a ``size``
    x ``size`` spatial window (nn/SpatialWithinChannelLRN.scala): ``y =
    x / (1 + alpha / size^2 * sum x^2) ** beta``, the window padded as
    :class:`SpatialCrossMapLRN`'s, in H and in W."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta

    def forward(self, x):
        summed = _window_sum(_window_sum(x * x, x.ndim - 2, self.size),
                             x.ndim - 1, self.size)
        denom = torch.pow(
            1.0 + self.alpha / (self.size * self.size) * summed, self.beta)
        return x / denom


class Normalize(Module):
    """Lp normalization along axis 1 (nn/Normalize.scala): ``x / (||x||_p
    + eps)``, ``p = inf`` the largest magnitude."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p = p
        self.eps = eps

    def forward(self, x):
        if self.p == float("inf"):
            norm = x.abs().amax(dim=1, keepdim=True)
        else:
            norm = x.abs().pow(self.p).sum(dim=1, keepdim=True) \
                .pow(1.0 / self.p)
        return x / (norm + self.eps)


def _gaussian_kernel_2d(kernel_size: int, dtype=torch.float32):
    """The normalizations' default ``kernel_size`` square Gaussian
    (sigma a quarter of the size), summing to 1, in ``dtype``: the JAX
    package's ``_gaussian_kernel_2d``."""
    xs = torch.arange(kernel_size, dtype=dtype) - (kernel_size - 1) / 2.0
    g = torch.exp(-(xs ** 2) / (2 * (0.25 * kernel_size) ** 2))
    k2 = g[:, None] * g[None, :]
    return k2 / k2.sum()


class SpatialSubtractiveNormalization(Module):
    """Subtract a weighted local mean
    (nn/SpatialSubtractiveNormalization.scala). ``kernel`` is a 2-D
    array (default a 9 x 9 :func:`_gaussian_kernel_2d`), normalized to
    sum 1.

    As in the JAX package, the mean is one plane: the kernel's window
    summed over every input plane and divided by ``n_input_plane``, and
    subtracted from each plane (not Torch's per-plane form with border
    coefficients). The window is padded ``(k // 2, (k - 1) // 2)``,
    which is uneven for an even kernel."""

    def __init__(self, n_input_plane: int = 1, kernel=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.kernel = kernel

    def _local_mean(self, x):
        if self.kernel is None:
            k = _gaussian_kernel_2d(9, x.dtype).to(x.device)
        else:
            k = torch.as_tensor(np.asarray(self.kernel), dtype=x.dtype,
                                device=x.device)
        k = k / k.sum()
        kh, kw = k.shape
        w = k[None, None].expand(1, self.n_input_plane, kh, kw) \
            / self.n_input_plane
        if x.is_cuda:
            full_float32()
        x = F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
        return F.conv2d(x, w)

    def forward(self, x):
        return x - self._local_mean(x)


class SpatialDivisiveNormalization(SpatialSubtractiveNormalization):
    """Divide by the local standard deviation
    (nn/SpatialDivisiveNormalization.scala): ``std`` is the square root
    of the local mean of ``x^2`` (:class:`SpatialSubtractiveNormalization`'s
    window), the divisor ``max(std, its mean over the plane)``, and
    ``thresval`` where that is below ``threshold``."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__(n_input_plane, kernel)
        self.threshold = threshold
        self.thresval = thresval

    def forward(self, x):
        local_sq = self._local_mean(x * x)
        std = torch.sqrt(torch.maximum(local_sq, local_sq.new_zeros(())))
        denom = torch.maximum(std, std.mean(dim=(2, 3), keepdim=True))
        denom = torch.where(denom < self.threshold, self.thresval, denom)
        return x / denom


class SpatialContrastiveNormalization(Module):
    """Subtractive then divisive normalization with one kernel
    (nn/SpatialContrastiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold, thresval)

    def forward(self, x):
        return self.div(self.sub(x))

"""Int8 calibration — the ONE activation-scale estimation path
(counterpart of ``bigdl_tpu.precision.calibrate``).

Every int8 scale derives from the symmetric max-abs rule
(:func:`bigdl_tpu_torch.ops.quant.scale_from_amax`, ``max|x| / 127`` in
float32). :func:`collect_activation_scales` runs calibration batches
through the FLOAT model once, recording the running max-abs of every
quantizable layer's input; the per-layer scale is baked into the int8
twin by :func:`bigdl_tpu_torch.nn.quantized.quantize`, replacing the
per-batch dynamic estimate — cheaper on the serving path, and the thing
an accuracy gate can certify.

The JAX package intercepts each target's ``apply``; the port registers
a forward pre-hook on each target and removes every hook in a
``finally`` block, so the model is left exactly as it was.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, List, Optional

import torch
from torch import nn

from bigdl_tpu_torch.ops.quant import scale_from_amax
from bigdl_tpu_torch.utils.engine import model_device

__all__ = ["collect_activation_scales", "maybe_collect", "scale_from_amax"]


def _quantizable(m: nn.Module) -> bool:
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    from bigdl_tpu_torch.nn.linear import Linear
    return isinstance(m, Linear) or (
        isinstance(m, SpatialConvolution) and m.n_group == 1)


@contextlib.contextmanager
def evaluating(model: nn.Module) -> Iterator[nn.Module]:
    """``model`` in evaluation mode without autograd for the block;
    every submodule's own mode is restored after (the JAX package runs
    these forwards with ``training=False`` and never flips a mode)."""
    modes = [(m, m.training) for m in model.modules()]
    try:
        model.eval()
        with torch.inference_mode():
            yield model
    finally:
        for m, mode in modes:
            m.training = mode


def collect_activation_scales(model: nn.Module,
                              batches: Iterable) -> Dict[int, float]:
    """Run ``batches`` through the float ``model`` in evaluation mode
    (its mode is restored after) and return ``{id(module):
    activation_scale}`` for every quantizable layer (Linear, ungrouped
    SpatialConvolution): the per-tensor symmetric scale of the layer's
    OBSERVED input range, through the shared max-abs rule, as a Python
    float holding the float32 value. Keys are module identities so
    :func:`~bigdl_tpu_torch.nn.quantized.quantize` can look its
    conversion targets up."""
    targets: List[nn.Module] = [m for m in model.modules()
                                if _quantizable(m)]
    if not targets:
        raise ValueError(
            "model has no quantizable layers (Linear / ungrouped "
            "SpatialConvolution); nothing to calibrate")
    amax: Dict[int, float] = {}

    def record(module, args):
        x = args[0]
        peak = float(x.detach().abs().max()) if x.numel() else 0.0
        amax[id(module)] = max(amax.get(id(module), 0.0), peak)

    device = model_device(model)
    handles = [m.register_forward_pre_hook(record) for m in targets]
    saw_batch = False
    try:
        with evaluating(model):
            for batch in batches:
                saw_batch = True
                model(torch.as_tensor(batch, device=device))
    finally:
        for h in handles:
            h.remove()
    if not saw_batch:
        raise ValueError("calibration needs at least one batch")
    return {mid: float(scale_from_amax(peak)) for mid, peak in amax.items()}


def maybe_collect(model: nn.Module, calibration: Optional[Iterable]
                  ) -> Optional[Dict[int, float]]:
    """:func:`collect_activation_scales` when ``calibration`` is given,
    else None."""
    if calibration is None:
        return None
    return collect_activation_scales(model, calibration)

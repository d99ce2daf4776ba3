"""Device and dtype policy — the slice of ``bigdl_tpu.utils.engine``
the port needs (no mesh yet).

The JAX package lets ``jax.devices()`` pick the platform; the port
makes the choice explicit instead. ``resolve_device(None)`` is the
card, and a missing card is an error, never a silent run on the CPU:
a caller who wants the CPU asks for it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_dtype", "full_float32", "model_device",
           "resolve_device"]

#: parameter / activation dtype of every module the port builds (the
#: JAX package's ``Engine.default_dtype()`` default)
_DEFAULT_DTYPE = torch.float32


def default_dtype() -> torch.dtype:
    """The dtype new parameters and caches are created in."""
    return _DEFAULT_DTYPE


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def full_float32() -> None:
    """Run float32 matrix products and convolutions on the card in full
    float32. PyTorch's cuDNN default (``torch.backends.cudnn.allow_tf32
    = True``) runs every float32 convolution in TF32 on Hopper, about
    three decimal digits; the port's float32 models are references (the
    accuracy gate's float model among them), so the convolution layers
    call this before their first run on the card. It switches TF32 off
    for the process and never back on."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def model_device(model: torch.nn.Module) -> torch.device:
    """Where ``model``'s first parameter (or buffer) lives; the CPU for
    a model with neither."""
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return torch.device("cpu")

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

__all__ = ["default_dtype", "resolve_device"]

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

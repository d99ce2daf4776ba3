"""Device and dtype policy — the slice of ``bigdl_tpu.utils.engine``
the port needs (no mesh yet).

The dtype knobs are the JAX package's ``Engine.set_default_dtype`` /
``set_compute_dtype``: the pre-policy configuration surface, which
``PrecisionPolicy.from_engine()`` reads. ``default_dtype()`` is the
dtype new parameters, caches and staged learning rates are made in.

The JAX package lets ``jax.devices()`` pick the platform; the port
makes the choice explicit instead. ``resolve_device(None)`` is the
card, and a missing card is an error, never a silent run on the CPU:
a caller who wants the CPU asks for it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["compute_dtype", "default_dtype", "full_float32",
           "model_device", "resolve_device", "set_compute_dtype",
           "set_default_dtype", "to_torch_dtype"]

#: parameter dtype of every module the port builds, and the activation
#: and matmul dtype (the JAX package's ``Engine`` defaults, float32)
_DTYPES = {"default": torch.float32, "compute": torch.float32}


def to_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or a name
    (``"bfloat16"``, ``"float16"``, ``"float32"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    got = getattr(torch, str(name).split(".")[-1], None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return got


def set_default_dtype(dtype) -> None:
    """Parameter dtype of the modules built from now on (BigDL's
    Float/Double TensorNumeric choice; the JAX package's
    ``Engine.set_default_dtype``)."""
    _DTYPES["default"] = to_torch_dtype(dtype)


def default_dtype() -> torch.dtype:
    """The dtype new parameters and caches are created in."""
    return _DTYPES["default"]


def set_compute_dtype(dtype) -> None:
    """Activation and matmul dtype that ``PrecisionPolicy.from_engine()``
    reports (the JAX package's ``Engine.set_compute_dtype``)."""
    _DTYPES["compute"] = to_torch_dtype(dtype)


def compute_dtype() -> torch.dtype:
    return _DTYPES["compute"]


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

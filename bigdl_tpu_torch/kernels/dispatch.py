"""The kernel dispatch layer — every hand-written kernel enters here
(counterpart of ``bigdl_tpu.kernels.dispatch``).

The JAX package's dispatch returns ``None`` on a decline so the caller
runs its jnp path. The port has no such decline on the card: a CUDA
tensor reaches the kernel or the call raises, and the plain PyTorch
version runs only for tensors on the CPU (inside each kernel's
wrapper). What this layer owns is the structural check of the operands
before they reach a wrapper.
"""
from __future__ import annotations

from typing import Optional

from bigdl_tpu_torch.kernels.ragged_decode import ragged_decode_attention

__all__ = ["decode_attention"]


def decode_attention(q, k, v, lengths, *,
                     sm_scale: Optional[float] = None):
    """Ragged-decode dispatch: ``q [slots, H, D]`` (one token per slot),
    ``k``/``v`` ``[slots, H, T, D]`` cache slices, ``lengths [slots]``
    int32 valid-KV rows per slot. Raises ValueError/TypeError on
    operands the kernel does not take."""
    if k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"k/v must be [slots, H, T, D] of one shape, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    slots, h, _, d = k.shape
    if q.shape != (slots, h, d):
        raise ValueError(f"q {tuple(q.shape)} must be [slots, H, D] = "
                         f"{(slots, h, d)}")
    if lengths.shape != (slots,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be "
                         f"[slots] = ({slots},)")
    if not (q.dtype.is_floating_point and k.dtype == q.dtype
            and v.dtype == q.dtype):
        raise TypeError(f"q/k/v must share one floating dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    return ragged_decode_attention(q, k, v, lengths, sm_scale=sm_scale)

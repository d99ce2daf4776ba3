"""Hand-written Hopper kernels of the port (counterpart of
``bigdl_tpu.kernels``).

Each kernel has a CUDA C++ source under ``csrc/`` (built by
:mod:`bigdl_tpu_torch.kernels._build` at first use, never at import),
a plain PyTorch version in the same module, and a wrapper that runs the
plain version for CPU tensors and launches the kernel for CUDA tensors,
counting its launches.

========================  ==========================  ==================
port wrapper              CUDA source                 replaces (TPU)
========================  ==========================  ==================
``decode_attention``      ``csrc/ragged_decode.cu``   ``bigdl_tpu/kernels/
                                                      ragged_decode.py:
                                                      _decode_kernel``
========================  ==========================  ==================
"""
from bigdl_tpu_torch.kernels.dispatch import decode_attention
from bigdl_tpu_torch.kernels.ragged_decode import (
    ragged_decode_attention, ragged_decode_attention_reference)

__all__ = ["decode_attention", "ragged_decode_attention",
           "ragged_decode_attention_reference"]

"""Hand-written Hopper kernels of the port (counterpart of
``bigdl_tpu.kernels``).

Each kernel has a CUDA C++ source under ``csrc/`` (built by
:mod:`bigdl_tpu_torch.kernels._build` at first use, never at import),
a plain PyTorch version in the same module, and a wrapper that runs the
plain version for CPU tensors and launches the kernel for CUDA tensors,
counting its launches. :mod:`~bigdl_tpu_torch.kernels.config` says which
kernels the dispatch layer may select.

Kernels (port wrapper — CUDA source — the TPU kernel body it replaces):

- K1 forward: ``attention`` → ``flash_attention_forward`` —
  ``csrc/flash_attention.cu`` — ``bigdl_tpu/kernels/flash_attention.py``
  ``_fwd_kernel``;
- K1 backward: ``flash_attention_backward`` — ``csrc/flash_attention.cu``
  — ``flash_attention.py`` ``_bwd_kernel``;
- K2 forward: ``attention`` (past the working-set budget) →
  ``blockwise_flash_attention_forward`` —
  ``csrc/blockwise_flash_attention.cu`` — ``flash_attention.py``
  ``_bw_fwd_kernel``; also the attention layer's route for score
  matrices over 2 GiB (the JAX package's ``_flash_attention_tpu``);
- K2 backward: ``blockwise_flash_attention_backward`` —
  ``csrc/blockwise_flash_attention.cu`` — ``flash_attention.py``
  ``_bw_dq_kernel`` and ``_bw_dkv_kernel`` (the backward kernels are
  ``csrc/flash_common.cuh``'s, shared with K1);
- K3: ``decode_attention`` → ``ragged_decode_attention`` —
  ``csrc/ragged_decode.cu`` — ``bigdl_tpu/kernels/ragged_decode.py``
  ``_decode_kernel``.
"""
from bigdl_tpu_torch.kernels.config import (KernelConfig, configure,
                                            enabled, get_config, use)
from bigdl_tpu_torch.kernels.dispatch import (attention, decode_attention,
                                              flash_route)
from bigdl_tpu_torch.kernels.flash_attention import (
    blockwise_flash_attention, blockwise_flash_attention_backward,
    blockwise_flash_attention_backward_reference,
    blockwise_flash_attention_forward,
    blockwise_flash_attention_forward_reference, flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference, flash_attention_forward,
    flash_attention_forward_reference)
from bigdl_tpu_torch.kernels.ragged_decode import (
    ragged_decode_attention, ragged_decode_attention_reference)

__all__ = ["KernelConfig", "attention", "blockwise_flash_attention",
           "blockwise_flash_attention_backward",
           "blockwise_flash_attention_backward_reference",
           "blockwise_flash_attention_forward",
           "blockwise_flash_attention_forward_reference", "configure",
           "decode_attention",
           "enabled", "flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_forward",
           "flash_attention_forward_reference", "flash_route", "get_config",
           "ragged_decode_attention", "ragged_decode_attention_reference",
           "use"]

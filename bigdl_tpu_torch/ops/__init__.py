"""Tensor ops of the port (counterpart of ``bigdl_tpu.ops``: the int8
quantization primitives so far)."""
from bigdl_tpu_torch.ops.quant import (int8_matmul, quantize_symmetric,
                                       quantize_with_scale, quantized_conv2d,
                                       quantized_linear, scale_from_amax)

__all__ = ["int8_matmul", "quantize_symmetric", "quantize_with_scale",
           "quantized_conv2d", "quantized_linear", "scale_from_amax"]

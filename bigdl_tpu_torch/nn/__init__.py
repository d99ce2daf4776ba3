"""Layers and criterions of the port (counterpart of
``bigdl_tpu.nn``)."""
from bigdl_tpu_torch.nn.activation import Identity, ReLU
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          dot_product_attention)
from bigdl_tpu_torch.nn.container import (Concat, ConcatTable, Container,
                                          Sequential)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (Criterion,
                                          SequenceCrossEntropyCriterion)
from bigdl_tpu_torch.nn.linear import Linear, MulConstant
from bigdl_tpu_torch.nn.norm import (BatchNormalization, LayerNorm,
                                     SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pool import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution,
                                          quantize)
from bigdl_tpu_torch.nn.shape import View
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = ["BatchNormalization", "CAddTable", "Concat", "ConcatTable",
           "Container", "Criterion", "Identity", "LayerNorm", "Linear",
           "MulConstant", "MultiHeadAttention", "QuantizedLinear",
           "QuantizedSpatialConvolution", "ReLU",
           "SequenceCrossEntropyCriterion", "Sequential",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling", "View",
           "dot_product_attention", "quantize"]

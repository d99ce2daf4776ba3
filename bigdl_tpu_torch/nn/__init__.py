"""Layers and criterions of the port (counterpart of
``bigdl_tpu.nn``)."""
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          dot_product_attention)
from bigdl_tpu_torch.nn.criterion import (Criterion,
                                          SequenceCrossEntropyCriterion)
from bigdl_tpu_torch.nn.norm import LayerNorm

__all__ = ["Criterion", "LayerNorm", "MultiHeadAttention",
           "SequenceCrossEntropyCriterion", "dot_product_attention"]

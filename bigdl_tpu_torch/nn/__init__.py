"""Layers and criterions of the port (counterpart of
``bigdl_tpu.nn``), all on the :class:`~bigdl_tpu_torch.nn.module.Module`
contract."""
from bigdl_tpu_torch.nn.activation import (
    ELU, Abs, BinaryThreshold, Clamp, Echo, Exp, GaussianSampler,
    GradientReversal, HardShrink, HardSigmoid, HardTanh, Identity, LeakyReLU,
    Log, Log1p, LogSigmoid, LogSoftMax, Negative, Power, PReLU, ReLU, ReLU6,
    RReLU, Sigmoid, SoftMax, SoftMin, SoftPlus, SoftShrink, SoftSign, Sqrt,
    Square, Tanh, TanhShrink, Threshold)
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          dot_product_attention)
from bigdl_tpu_torch.nn.container import (Concat, ConcatTable, Container,
                                          Sequential)
from bigdl_tpu_torch.nn.control_ops import IfThenElse, MergeOps, SwitchOps
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.dropout import Dropout, L1Penalty, SpatialDropout2D
from bigdl_tpu_torch.nn.criterion import (BCECriterion, ClassNLLCriterion,
                                          CrossEntropyCriterion,
                                          MSECriterion,
                                          SequenceCrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.graph import Graph, Input
from bigdl_tpu_torch.nn.linear import AddConstant, Linear, MulConstant
from bigdl_tpu_torch.nn.module import (Criterion, Module,
                                       total_regularization)
from bigdl_tpu_torch.nn.moe import MoE
from bigdl_tpu_torch.nn.norm import (BatchNormalization, LayerNorm, RMSNorm,
                                     SpatialBatchNormalization,
                                     SpatialCrossMapLRN,
                                     SpatialWithinChannelLRN)
from bigdl_tpu_torch.nn.pool import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution,
                                          quantize)
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent, Cell,
                                          ConvLSTMPeephole,
                                          ConvLSTMPeephole3D, LSTMPeephole,
                                          Recurrent, RecurrentDecoder,
                                          RnnCell, TimeDistributed)
from bigdl_tpu_torch.nn.shape import Reshape, View
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = ["Abs", "AddConstant", "BCECriterion", "BatchNormalization",
           "BiRecurrent", "BinaryThreshold", "CAddTable", "Cell", "Clamp",
           "ClassNLLCriterion", "Concat", "ConcatTable", "Container",
           "ConvLSTMPeephole", "ConvLSTMPeephole3D", "Criterion",
           "CrossEntropyCriterion", "Dropout", "ELU", "Echo", "Exp", "GRU",
           "GaussianSampler", "GradientReversal", "Graph", "HardShrink",
           "HardSigmoid", "HardTanh", "Identity", "IfThenElse", "Input",
           "L1Penalty", "LSTM", "LSTMPeephole", "LayerNorm", "LeakyReLU",
           "Linear", "Log", "Log1p", "LogSigmoid", "LogSoftMax",
           "LookupTable", "MSECriterion", "MergeOps", "MoE", "Module",
           "MulConstant", "MultiHeadAttention", "Negative", "PReLU", "Power",
           "QuantizedLinear", "QuantizedSpatialConvolution", "RMSNorm",
           "RReLU", "ReLU", "ReLU6", "Recurrent", "RecurrentDecoder",
           "Reshape", "RnnCell", "SequenceCrossEntropyCriterion",
           "Sequential", "Sigmoid", "SoftMax", "SoftMin", "SoftPlus",
           "SoftShrink", "SoftSign", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialCrossMapLRN", "SpatialDropout2D", "SpatialMaxPooling",
           "SpatialWithinChannelLRN", "Sqrt", "Square", "SwitchOps", "Tanh",
           "TanhShrink", "Threshold", "TimeDistributed",
           "TimeDistributedCriterion", "View", "dot_product_attention",
           "quantize", "total_regularization"]

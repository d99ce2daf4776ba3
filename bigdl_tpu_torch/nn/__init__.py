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
from bigdl_tpu_torch.nn.container import (Bottle, Concat, ConcatTable,
                                          Container, MapTable, MixtureTable,
                                          NarrowTable, ParallelTable,
                                          Sequential)
from bigdl_tpu_torch.nn.control_ops import IfThenElse, MergeOps, SwitchOps
from bigdl_tpu_torch.nn.conv import SpatialConvolution, TemporalConvolution
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
from bigdl_tpu_torch.nn.shape import (
    BifurcateSplitTable, Contiguous, FlattenTable, Index, InferReshape,
    JoinTable, MaskedSelect, Max, Mean, Min, Narrow, Nms, Pack, Padding,
    Replicate, Reshape, ResizeBilinear, Reverse, Scale, Select, SelectTable,
    SpatialZeroPadding, SplitTable, Squeeze, Sum, Tile, Transpose, Unsqueeze,
    View)
from bigdl_tpu_torch.nn.sparse import (DenseToSparse, SparseJoinTable,
                                       SparseLinear)
from bigdl_tpu_torch.nn.table_ops import (CAddTable, CDivTable, CMaxTable,
                                          CMinTable, CMulTable, CSubTable)
from bigdl_tpu_torch.nn.tree_lstm import BinaryTreeLSTM, TreeLSTM

__all__ = ["Abs", "AddConstant", "BCECriterion", "BatchNormalization",
           "BiRecurrent", "BifurcateSplitTable", "BinaryThreshold",
           "BinaryTreeLSTM", "Bottle", "CAddTable", "CDivTable", "CMaxTable",
           "CMinTable", "CMulTable", "CSubTable", "Cell", "Clamp",
           "ClassNLLCriterion", "Concat", "ConcatTable", "Container",
           "Contiguous", "ConvLSTMPeephole", "ConvLSTMPeephole3D",
           "Criterion", "CrossEntropyCriterion", "DenseToSparse", "Dropout",
           "ELU", "Echo", "Exp", "FlattenTable", "GRU", "GaussianSampler",
           "GradientReversal", "Graph", "HardShrink", "HardSigmoid",
           "HardTanh", "Identity", "IfThenElse", "Index", "InferReshape",
           "Input", "JoinTable", "L1Penalty", "LSTM", "LSTMPeephole",
           "LayerNorm", "LeakyReLU", "Linear", "Log", "Log1p", "LogSigmoid",
           "LogSoftMax", "LookupTable", "MSECriterion", "MapTable",
           "MaskedSelect", "Max", "Mean", "MergeOps", "Min", "MixtureTable",
           "MoE", "Module", "MulConstant", "MultiHeadAttention", "Narrow",
           "NarrowTable", "Negative", "Nms", "PReLU", "Pack", "Padding",
           "ParallelTable", "Power", "QuantizedLinear",
           "QuantizedSpatialConvolution", "RMSNorm", "RReLU", "ReLU", "ReLU6",
           "Recurrent", "RecurrentDecoder", "Replicate", "Reshape",
           "ResizeBilinear", "Reverse", "RnnCell", "Scale", "Select",
           "SelectTable", "SequenceCrossEntropyCriterion", "Sequential",
           "Sigmoid", "SoftMax", "SoftMin", "SoftPlus", "SoftShrink",
           "SoftSign", "SparseJoinTable", "SparseLinear",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialDropout2D",
           "SpatialMaxPooling", "SpatialWithinChannelLRN",
           "SpatialZeroPadding", "SplitTable", "Sqrt", "Square", "Squeeze",
           "Sum", "SwitchOps", "Tanh", "TanhShrink", "TemporalConvolution",
           "Threshold", "Tile", "TimeDistributed", "TimeDistributedCriterion",
           "Transpose", "TreeLSTM", "Unsqueeze", "View",
           "dot_product_attention", "quantize", "total_regularization"]

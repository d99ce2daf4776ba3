"""Layers and criterions of the port (counterpart of
``bigdl_tpu.nn``), all on the :class:`~bigdl_tpu_torch.nn.module.Module`
contract: every public class of the JAX package's ``nn``, with its
initialization methods and regularizers re-exported as there.

``Params`` and ``State`` are not here: they name the trees of the JAX
package's functional ``init`` / ``apply`` contract, which the port does
not have (its parameters are the modules' own tensors).
``AUX_LOSS_KEY`` is MoE's buffer of its auxiliary loss."""
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
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialConvolutionMap,
                                     SpatialDilatedConvolution,
                                     SpatialFullConvolution,
                                     SpatialShareConvolution,
                                     TemporalConvolution,
                                     VolumetricConvolution,
                                     VolumetricFullConvolution)
from bigdl_tpu_torch.nn.dropout import Dropout, L1Penalty, SpatialDropout2D
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, BCECriterion, ClassNLLCriterion, ClassSimplexCriterion,
    CosineDistanceCriterion, CosineEmbeddingCriterion, CrossEntropyCriterion,
    DiceCoefficientCriterion, DistKLDivCriterion, GaussianCriterion,
    HingeEmbeddingCriterion, KLDCriterion, L1Cost, L1HingeEmbeddingCriterion,
    MarginCriterion, MarginRankingCriterion, MSECriterion, MultiCriterion,
    MultiLabelMarginCriterion, MultiLabelSoftMarginCriterion,
    MultiMarginCriterion, ParallelCriterion, SequenceCrossEntropyCriterion,
    SmoothL1Criterion, SmoothL1CriterionWithWeights, SoftMarginCriterion,
    SoftmaxWithCriterion, TimeDistributedCriterion)
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.graph import Graph, Input
from bigdl_tpu_torch.nn.initialization import (BilinearFiller,
                                               ConstInitMethod,
                                               InitializationMethod,
                                               MsraFiller, Ones,
                                               RandomNormal, RandomUniform,
                                               Xavier, Zeros)
from bigdl_tpu_torch.nn.linear import (MM, MV, Add, AddConstant, Bilinear,
                                       CAdd, CMul, Cosine, CosineDistance,
                                       DotProduct, Euclidean, Linear, Mul,
                                       MulConstant, PairwiseDistance)
from bigdl_tpu_torch.nn.module import (Criterion, Module,
                                       total_regularization)
from bigdl_tpu_torch.nn.moe import AUX_LOSS_KEY, MoE
from bigdl_tpu_torch.nn.norm import (BatchNormalization, LayerNorm,
                                     Normalize, RMSNorm,
                                     SpatialBatchNormalization,
                                     SpatialContrastiveNormalization,
                                     SpatialCrossMapLRN,
                                     SpatialDivisiveNormalization,
                                     SpatialSubtractiveNormalization,
                                     SpatialWithinChannelLRN)
from bigdl_tpu_torch.nn.pool import (RoiPooling, SpatialAveragePooling,
                                     SpatialMaxPooling, TemporalMaxPooling,
                                     VolumetricMaxPooling)
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

# last: the optim package's import reaches back into this one
from bigdl_tpu_torch.optim.regularizer import (  # noqa: E402
    L1L2Regularizer, L1Regularizer, L2Regularizer, Regularizer)

__all__ = ["AUX_LOSS_KEY", "Abs", "AbsCriterion", "Add", "AddConstant",
           "BCECriterion", "BatchNormalization", "BiRecurrent",
           "BifurcateSplitTable", "Bilinear", "BilinearFiller",
           "BinaryThreshold", "BinaryTreeLSTM", "Bottle", "CAdd", "CAddTable",
           "CDivTable", "CMaxTable", "CMinTable", "CMul", "CMulTable",
           "CSubTable", "Cell", "Clamp", "ClassNLLCriterion",
           "ClassSimplexCriterion", "Concat", "ConcatTable",
           "ConstInitMethod", "Container", "Contiguous", "ConvLSTMPeephole",
           "ConvLSTMPeephole3D", "Cosine", "CosineDistance",
           "CosineDistanceCriterion", "CosineEmbeddingCriterion", "Criterion",
           "CrossEntropyCriterion", "DenseToSparse",
           "DiceCoefficientCriterion", "DistKLDivCriterion", "DotProduct",
           "Dropout", "ELU", "Echo", "Euclidean", "Exp", "FlattenTable",
           "GRU", "GaussianCriterion", "GaussianSampler", "GradientReversal",
           "Graph", "HardShrink", "HardSigmoid", "HardTanh",
           "HingeEmbeddingCriterion", "Identity", "IfThenElse", "Index",
           "InferReshape", "InitializationMethod", "Input", "JoinTable",
           "KLDCriterion", "L1Cost", "L1HingeEmbeddingCriterion",
           "L1L2Regularizer", "L1Penalty", "L1Regularizer", "L2Regularizer",
           "LSTM", "LSTMPeephole", "LayerNorm", "LeakyReLU", "Linear", "Log",
           "Log1p", "LogSigmoid", "LogSoftMax", "LookupTable", "MM",
           "MSECriterion", "MV", "MapTable", "MarginCriterion",
           "MarginRankingCriterion", "MaskedSelect", "Max", "Mean",
           "MergeOps", "Min", "MixtureTable", "MoE", "Module", "MsraFiller",
           "Mul", "MulConstant", "MultiCriterion", "MultiHeadAttention",
           "MultiLabelMarginCriterion", "MultiLabelSoftMarginCriterion",
           "MultiMarginCriterion", "Narrow", "NarrowTable", "Negative", "Nms",
           "Normalize", "Ones", "PReLU", "Pack", "Padding",
           "PairwiseDistance", "ParallelCriterion", "ParallelTable", "Power",
           "QuantizedLinear", "QuantizedSpatialConvolution", "RMSNorm",
           "RReLU", "RandomNormal", "RandomUniform", "ReLU", "ReLU6",
           "Recurrent", "RecurrentDecoder", "Regularizer", "Replicate",
           "Reshape", "ResizeBilinear", "Reverse", "RnnCell", "RoiPooling",
           "Scale", "Select", "SelectTable", "SequenceCrossEntropyCriterion",
           "Sequential", "Sigmoid", "SmoothL1Criterion",
           "SmoothL1CriterionWithWeights", "SoftMarginCriterion", "SoftMax",
           "SoftMin", "SoftPlus", "SoftShrink", "SoftSign",
           "SoftmaxWithCriterion", "SparseJoinTable", "SparseLinear",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialContrastiveNormalization", "SpatialConvolution",
           "SpatialConvolutionMap", "SpatialCrossMapLRN",
           "SpatialDilatedConvolution", "SpatialDivisiveNormalization",
           "SpatialDropout2D", "SpatialFullConvolution", "SpatialMaxPooling",
           "SpatialShareConvolution", "SpatialSubtractiveNormalization",
           "SpatialWithinChannelLRN", "SpatialZeroPadding", "SplitTable",
           "Sqrt", "Square", "Squeeze", "Sum", "SwitchOps", "Tanh",
           "TanhShrink", "TemporalConvolution", "TemporalMaxPooling",
           "Threshold", "Tile", "TimeDistributed", "TimeDistributedCriterion",
           "Transpose", "TreeLSTM", "Unsqueeze", "View",
           "VolumetricConvolution", "VolumetricFullConvolution",
           "VolumetricMaxPooling", "Xavier", "Zeros", "dot_product_attention",
           "quantize", "total_regularization"]

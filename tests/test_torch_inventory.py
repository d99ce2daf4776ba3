"""The port twin of ``tests/test_inventory_layers.py``: the whole layer
inventory in ``bigdl_tpu_torch.nn``, every public name of ``bigdl_tpu.nn``
there too (apart from the names listed absent, each with its reason),
every public class defined under ``bigdl_tpu/nn/`` ported, and the
inventory file's SpatialConvolutionMap, Nms and BinaryTreeLSTM checks
run through the port."""
import ast
import glob
import inspect
import os

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as nn

#: names of ``bigdl_tpu.nn`` the port leaves out, with the reason
ABSENT = {
    "Params": "the type of the JAX functional init/apply contract's "
              "parameter tree; the port's parameters are each module's "
              "own tensors (get_parameters returns a plain dict)",
    "State": "the type of the JAX functional contract's state tree; the "
             "port's state is each module's buffers",
}

#: ``tests/test_inventory_layers.py::test_full_inventory_present``'s list
INVENTORY = """Sequential Container Graph Input Concat ConcatTable
    ParallelTable MapTable NarrowTable Bottle MixtureTable Linear
    SparseLinear Bilinear CMul CAdd Mul Add MulConstant AddConstant MM MV
    Cosine Euclidean DotProduct PairwiseDistance CosineDistance
    SpatialConvolution SpatialShareConvolution SpatialDilatedConvolution
    SpatialFullConvolution SpatialConvolutionMap TemporalConvolution
    VolumetricConvolution VolumetricFullConvolution LookupTable
    SpatialMaxPooling SpatialAveragePooling TemporalMaxPooling
    VolumetricMaxPooling RoiPooling BatchNormalization
    SpatialBatchNormalization SpatialCrossMapLRN SpatialWithinChannelLRN
    SpatialContrastiveNormalization SpatialDivisiveNormalization
    SpatialSubtractiveNormalization Normalize ReLU ReLU6 PReLU RReLU
    LeakyReLU ELU Tanh TanhShrink Sigmoid LogSigmoid SoftMax SoftMin
    LogSoftMax SoftPlus SoftSign SoftShrink HardShrink HardTanh Threshold
    BinaryThreshold Clamp Power Square Sqrt Log Exp Abs Negative
    GradientReversal GaussianSampler Reshape InferReshape View Squeeze
    Unsqueeze Transpose Contiguous Replicate Padding SpatialZeroPadding
    Narrow Select SelectTable MaskedSelect Index Max Min Mean Sum Scale
    Tile Pack Reverse SplitTable BifurcateSplitTable JoinTable
    SparseJoinTable FlattenTable DenseToSparse ResizeBilinear Nms
    CAddTable CSubTable CMulTable CDivTable CMaxTable CMinTable Dropout
    L1Penalty Recurrent RecurrentDecoder RnnCell LSTM LSTMPeephole GRU
    ConvLSTMPeephole ConvLSTMPeephole3D BiRecurrent TimeDistributed
    TreeLSTM BinaryTreeLSTM ClassNLLCriterion CrossEntropyCriterion
    BCECriterion MSECriterion AbsCriterion SmoothL1Criterion
    MarginCriterion MarginRankingCriterion MultiMarginCriterion
    MultiLabelMarginCriterion MultiLabelSoftMarginCriterion
    HingeEmbeddingCriterion L1HingeEmbeddingCriterion
    CosineEmbeddingCriterion CosineDistanceCriterion DistKLDivCriterion
    KLDCriterion GaussianCriterion ClassSimplexCriterion
    DiceCoefficientCriterion SoftmaxWithCriterion SoftMarginCriterion
    L1Cost ParallelCriterion MultiCriterion TimeDistributedCriterion
    MultiHeadAttention MoE LayerNorm RMSNorm QuantizedLinear
    QuantizedSpatialConvolution SequenceCrossEntropyCriterion""".split()


def test_full_inventory_present():
    missing = [n for n in INVENTORY if not hasattr(nn, n)]
    assert missing == [], f"missing layers: {missing}"


def test_every_public_name_of_the_jax_nn_is_exported_or_absent_with_reason():
    public = [n for n in dir(jnn) if not n.startswith("_")
              and not inspect.ismodule(getattr(jnn, n))]
    missing = sorted(n for n in public if not hasattr(nn, n)
                     and n not in ABSENT)
    assert missing == [], f"neither exported nor listed absent: {missing}"
    assert all(not hasattr(nn, n) for n in ABSENT)
    assert all(reason for reason in ABSENT.values())
    assert sorted(set(nn.__all__)) == sorted(nn.__all__)
    assert all(hasattr(nn, n) for n in nn.__all__)


def _jax_classes():
    """``{name: file}`` of the public classes defined under
    ``bigdl_tpu/nn/``."""
    root = os.path.dirname(jnn.__file__)
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "*.py"))):
        with open(path) as f:
            for node in ast.parse(f.read()).body:
                if isinstance(node, ast.ClassDef) and node.name[0].isupper():
                    out[node.name] = os.path.basename(path)
    return out


def test_all_184_classes_of_the_jax_nn_are_ported():
    classes = _jax_classes()
    assert len(classes) == 184
    missing = sorted(f"{f}:{n}" for n, f in classes.items()
                     if not isinstance(getattr(nn, n, None), type))
    assert missing == []


def test_the_reexported_initializers_and_regularizers_are_the_ports():
    from bigdl_tpu_torch.nn import initialization
    from bigdl_tpu_torch.optim import regularizer
    for name in ("InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
                 "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
                 "BilinearFiller"):
        assert getattr(nn, name) is getattr(initialization, name)
    for name in ("Regularizer", "L1L2Regularizer", "L1Regularizer",
                 "L2Regularizer"):
        assert getattr(nn, name) is getattr(regularizer, name)
    from bigdl_tpu_torch.nn.moe import AUX_LOSS_KEY
    assert nn.AUX_LOSS_KEY == AUX_LOSS_KEY == jnn.AUX_LOSS_KEY


def test_spatial_convolution_map():
    # LeNet-style partial connectivity: plane 1 -> out 1,2; plane 2 -> out 2
    table = [[1, 1], [1, 2], [2, 2]]
    m = nn.SpatialConvolutionMap(table, 3, 3, 1, 1, 1, 1)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 2, 6, 6)
                         .astype(np.float32))
    with torch.no_grad():
        out = m(x)
        assert out.shape == (2, 2, 6, 6)
        # output 1 must NOT depend on input plane 2
        x2 = x.clone()
        x2[:, 1] += 10.0
        out2 = m(x2)
    torch.testing.assert_close(out[:, 0], out2[:, 0], atol=1e-5, rtol=0)
    assert (out[:, 1] - out2[:, 1]).abs().max() > 0.1


def test_nms():
    boxes = torch.tensor([[0, 0, 10, 10],
                          [1, 1, 11, 11],     # heavy overlap with 0
                          [20, 20, 30, 30],   # separate
                          [21, 21, 29, 29]],  # overlaps 2
                         dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7, 0.95])
    kept = nn.Nms(iou_threshold=0.5, max_output=4)([boxes, scores])
    kept = kept[kept >= 0]
    # order by score: 3, 0, 1 (suppressed by 0), 2 (suppressed by 3)
    assert kept.tolist() == [3, 0]


def test_binary_tree_lstm():
    # tree: leaves 0,1 -> node 2; leaf 3; root 4 = (2, 3)
    rng = np.random.RandomState(1)
    emb = torch.from_numpy(rng.randn(5, 8).astype(np.float32))
    children = torch.tensor([[-1, -1], [-1, -1], [0, 1], [-1, -1], [2, 3]])
    m = nn.BinaryTreeLSTM(8, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        hs = m([emb, children])
        assert hs.shape == (5, 16) and torch.isfinite(hs).all()
        # the root depends on leaf 0's embedding, leaf 3 does not
        emb2 = emb.clone()
        emb2[0] += 1.0
        hs2 = m([emb2, children])
    assert (hs2[4] - hs[4]).abs().max() > 1e-5
    torch.testing.assert_close(hs[3], hs2[3], atol=1e-6, rtol=0)


def test_binary_tree_lstm_gradients():
    emb = torch.from_numpy(np.random.RandomState(2).randn(3, 4)
                           .astype(np.float32))
    children = torch.tensor([[-1, -1], [-1, -1], [0, 1]])
    m = nn.BinaryTreeLSTM(4, 6, generator=torch.Generator().manual_seed(0))
    m([emb, children])[-1].sum().backward()
    grads = dict(m.named_parameters())
    assert grads["w_comp"].grad.abs().max() > 0
    assert grads["w_leaf"].grad.abs().max() > 0


@pytest.mark.parametrize("name", sorted(_jax_classes()))
def test_each_class_resolves_by_name_in_the_serializer(name):
    """``module_serializer`` finds every class by its JAX name."""
    from bigdl_tpu_torch.utils.module_serializer import _resolve
    assert _resolve(name) is getattr(nn, name)

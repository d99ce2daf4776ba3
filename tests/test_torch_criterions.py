"""The port's criterions (``bigdl_tpu_torch/nn/criterion.py``) against the
JAX package's (``bigdl_tpu/nn/criterion.py``) on the same seeded inputs:
the loss and its gradient with respect to every floating input leaf,
both ``size_average`` values where the criterion has one, Table inputs
and targets, and the JAX package's quirks the port mirrors (a positive
label id after a 0, an ``ignore_label`` outside the classes, 1-D
against 2-D ``DistKLDivCriterion``, ``repeat_target``). The cases
follow ``tests/test_golden_criterions.py``'s.

Tolerance: float32, 1e-5 absolute plus 1e-5 relative (the two packages
reduce in different orders)."""
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.utils.table import T

from _torch_parity import assert_criterion_parity

ATOL = 1e-5

torch.set_num_threads(1)


def _r(shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _sign(shape, seed):
    return np.where(_r(shape, seed) > 0, 1.0, -1.0).astype(np.float32)


def _probs(shape, seed):
    p = _r(shape, seed, 0.05, 1.0)
    return p / p.sum(axis=-1, keepdims=True)


def _crit(name, *args, **kw):
    return lambda nn: getattr(nn, name)(*args, **kw)


def _parallel(repeat):
    return lambda nn: nn.ParallelCriterion(repeat_target=repeat) \
        .add(nn.MSECriterion(), 0.5).add(nn.AbsCriterion(), 2.0)


def _multi(nn):
    return nn.MultiCriterion().add(nn.MSECriterion(), 1.0) \
        .add(nn.AbsCriterion(), 3.0).add(nn.SmoothL1Criterion(False), 0.25)


X45, T45 = _r((4, 5)), _r((4, 5), 1)
LABELS = np.asarray([1, 3, 5, 2], np.float32)
WEIGHTS5 = _r((5,), 9, 0.5, 1.5)

#: ``{id: (build(nn), input, target)}`` for the criterions that take
#: ``size_average`` (each runs with True and False)
AVERAGED = {
    "AbsCriterion": (_crit("AbsCriterion"), X45, T45),
    "SmoothL1Criterion": (_crit("SmoothL1Criterion"), 2 * X45, T45),
    "MarginCriterion": (_crit("MarginCriterion", 1.0), _r((6,)),
                        _sign((6,), 3)),
    "MarginCriterion-squared": (_crit("MarginCriterion", 0.7,
                                      squared=True), X45, _sign((4, 5), 4)),
    "MarginRankingCriterion": (_crit("MarginRankingCriterion", 0.5),
                               [_r((5,)), _r((5,), 1)], _sign((5,), 2)),
    "MarginRankingCriterion-table-target": (
        _crit("MarginRankingCriterion", 0.5), T(_r((5,)), _r((5,), 1)),
        T(_sign((5,), 2))),
    "MultiMarginCriterion-p1": (_crit("MultiMarginCriterion", 1,
                                      margin=1.0), X45, LABELS),
    "MultiMarginCriterion-p2-weights": (
        _crit("MultiMarginCriterion", 2, WEIGHTS5, margin=0.5), X45,
        LABELS),
    "MultiLabelMarginCriterion": (
        _crit("MultiLabelMarginCriterion"), _r((2, 4)),
        np.asarray([[3, 1, 0, 0], [4, 0, 0, 0]], np.float32)),
    # a positive id after the first 0 still counts (Torch would stop)
    "MultiLabelMarginCriterion-id-after-zero": (
        _crit("MultiLabelMarginCriterion"), _r((3, 5), 6),
        np.asarray([[3, 1, 0, 4, 0], [2, 0, 5, 0, 0], [5, 5, 1, 0, 2]],
                   np.float32)),
    "MultiLabelMarginCriterion-1d": (
        _crit("MultiLabelMarginCriterion"), _r((5,), 7),
        np.asarray([2, 0, 4, 0, 0], np.float32)),
    "MultiLabelSoftMarginCriterion": (
        _crit("MultiLabelSoftMarginCriterion"), _r((3, 4)),
        (np.random.RandomState(5).rand(3, 4) > 0.5).astype(np.float32)),
    "MultiLabelSoftMarginCriterion-weights": (
        _crit("MultiLabelSoftMarginCriterion", _r((4,), 8, 0.5, 2.0)),
        _r((3, 4)), (np.random.RandomState(5).rand(3, 4) > 0.5)
        .astype(np.float32)),
    "SoftMarginCriterion": (_crit("SoftMarginCriterion"), _r((3, 4)),
                            _sign((3, 4), 7)),
    "HingeEmbeddingCriterion": (
        _crit("HingeEmbeddingCriterion", 1.0), _r((6,), 0, 0.1, 2.0),
        np.asarray([1, -1, 1, -1, 1, -1], np.float32)),
    "CosineEmbeddingCriterion": (
        _crit("CosineEmbeddingCriterion", 0.3), T(_r((4, 6)),
                                                  _r((4, 6), 1)),
        np.asarray([1, -1, 1, -1], np.float32)),
    "CosineEmbeddingCriterion-1d-table-target": (
        _crit("CosineEmbeddingCriterion", 0.1), [_r((6,)), _r((6,), 1)],
        T(np.asarray([-1.0], np.float32))),
    "CosineDistanceCriterion": (_crit("CosineDistanceCriterion"),
                                _r((4, 6)), _r((4, 6), 1)),
    "CosineDistanceCriterion-1d": (_crit("CosineDistanceCriterion"),
                                   _r((6,)), _r((6,), 1)),
    "DistKLDivCriterion": (_crit("DistKLDivCriterion"),
                           np.log(_probs((3, 5), 0)), _probs((3, 5), 1)),
    # 1-D input averages over its elements, 2-D over its rows; a zero
    # target adds nothing
    "DistKLDivCriterion-1d-zero-target": (
        _crit("DistKLDivCriterion"), np.log(_probs((5,), 2)),
        np.asarray([0.5, 0.0, 0.25, 0.25, 0.0], np.float32)),
    "ClassSimplexCriterion": (_crit("ClassSimplexCriterion", 4),
                              _r((3, 4)), np.asarray([1, 2, 4], np.float32)),
    "ClassSimplexCriterion-wider-input": (
        _crit("ClassSimplexCriterion", 3), _r((3, 6)),
        np.asarray([3, 1, 2], np.float32)),
    "DiceCoefficientCriterion": (
        _crit("DiceCoefficientCriterion", epsilon=1.0),
        _r((2, 6), 0, 0.0, 1.0),
        (np.random.RandomState(9).rand(2, 6) > 0.5).astype(np.float32)),
    "DiceCoefficientCriterion-3d": (
        _crit("DiceCoefficientCriterion", epsilon=0.5),
        _r((2, 3, 4), 1, 0.0, 1.0),
        (np.random.RandomState(9).rand(2, 3, 4) > 0.5).astype(np.float32)),
}

#: criterions without ``size_average``
PLAIN = {
    "SmoothL1CriterionWithWeights": (
        _crit("SmoothL1CriterionWithWeights", 2.0, 3), 2 * X45,
        T(T45, _r((4, 5), 2, 0.0, 1.0), _r((4, 5), 3, 0.0, 1.0))),
    "SmoothL1CriterionWithWeights-plain-target": (
        _crit("SmoothL1CriterionWithWeights", 0.5), X45, T45),
    "L1HingeEmbeddingCriterion-similar": (
        _crit("L1HingeEmbeddingCriterion", 2.0), [_r((5,)), _r((5,), 1)],
        np.asarray(1.0, np.float32)),
    "L1HingeEmbeddingCriterion-dissimilar": (
        _crit("L1HingeEmbeddingCriterion", 9.0), T(_r((5,)), _r((5,), 1)),
        np.asarray(-1.0, np.float32)),
    "KLDCriterion": (_crit("KLDCriterion"),
                     T(_r((4, 3)), _r((4, 3), 1, -1, 1)), None),
    "GaussianCriterion": (_crit("GaussianCriterion"),
                          [_r((4, 3)), _r((4, 3), 1, -1, 1)],
                          _r((4, 3), 2)),
    "L1Cost": (_crit("L1Cost"), _r((4, 3)), None),
    "ParallelCriterion": (_parallel(False), T(X45, _r((4, 5), 2)),
                          T(T45, _r((4, 5), 3))),
    "ParallelCriterion-list-target": (_parallel(False), [X45, _r((4, 5), 2)],
                                      [T45, _r((4, 5), 3)]),
    "ParallelCriterion-repeat-target": (_parallel(True),
                                        [X45, _r((4, 5), 2)], T45),
    "MultiCriterion": (_multi, X45, T45),
}


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("case", sorted(AVERAGED))
def test_averaged_criterion_matches_jax(case, size_average):
    build, inp, target = AVERAGED[case]
    ref, port = build(jnn), build(pnn)
    ref.size_average = port.size_average = size_average
    assert_criterion_parity(ref, port, inp, target, ATOL)


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_criterion_matches_jax(case):
    build, inp, target = PLAIN[case]
    assert_criterion_parity(build(jnn), build(pnn), inp, target, ATOL)


def _fcn_labels(b, h, w, classes, seed, ignore=None, share=0.2):
    """``[B, H, W]`` 1-based labels, ``share`` of them ``ignore``."""
    rng = np.random.RandomState(seed)
    t = rng.randint(1, classes + 1, (b, h, w))
    if ignore is not None:
        t = np.where(rng.rand(b, h, w) < share, ignore, t)
    return t.astype(np.float32)


@pytest.mark.parametrize("mode", ["VALID", "BATCH_SIZE", "FULL", "NONE"])
@pytest.mark.parametrize("ignore", [None, 2, 255])
def test_softmax_with_criterion_matches_jax(mode, ignore):
    """Caffe's SoftmaxWithLoss over NCHW maps: every normalize mode, no
    ignore label, one inside the classes, and Caffe's usual 255 over 5
    classes (gathered out of range before the mask, in both packages:
    the masked positions add nothing, the loss and gradient agree)."""
    x = _r((2, 5, 3, 4), 11, -3.0, 3.0)
    t = _fcn_labels(2, 3, 4, 5, 12, ignore)
    if ignore is not None:
        assert (t == ignore).any()
    for target in (t, t[:, None]):        # [B, H, W] and [B, 1, H, W]
        assert_criterion_parity(
            jnn.SoftmaxWithCriterion(ignore, mode),
            pnn.SoftmaxWithCriterion(ignore, mode), x, target, ATOL)


def test_softmax_with_criterion_on_logit_rows_matches_jax():
    assert_criterion_parity(jnn.SoftmaxWithCriterion(),
                            pnn.SoftmaxWithCriterion(), _r((2, 5)),
                            np.asarray([2, 4], np.float32), ATOL)


def test_softmax_with_out_of_range_ignore_label_raises_nothing_and_masks():
    """The port clamps the out-of-range index before its gather, so no
    error is raised, and the ignored positions take no gradient."""
    x = torch.from_numpy(_r((1, 3, 2, 2), 3)).requires_grad_()
    t = torch.tensor([[[1.0, 255.0], [255.0, 3.0]]])
    loss = pnn.SoftmaxWithCriterion(255)(x, t)
    loss.backward()
    assert torch.isfinite(loss)
    assert torch.all(x.grad[0, :, 0, 1] == 0)
    assert torch.all(x.grad[0, :, 1, 0] == 0)
    assert torch.all(x.grad[0, :, 0, 0] != 0)


def test_multi_label_margin_counts_an_id_after_a_zero_as_jax_does():
    """Torch's convention stops a target row at its first 0; the JAX
    package, and so the port, counts every positive id of the row."""
    x = torch.from_numpy(_r((2, 5), 6))
    t = torch.tensor([[3.0, 1.0, 0.0, 4.0, 0.0], [2.0, 0.0, 5.0, 0.0, 0.0]])
    first_zero = torch.tensor([[3.0, 1.0, 0.0, 0.0, 0.0],
                               [2.0, 0.0, 0.0, 0.0, 0.0]])
    crit = pnn.MultiLabelMarginCriterion()
    got = crit(x, t).item()
    assert got == pytest.approx(float(jnn.MultiLabelMarginCriterion().apply(
        x.numpy(), t.numpy())), rel=1e-6)
    assert abs(got - crit(x, first_zero).item()) > 1e-3


def test_class_simplex_is_the_jax_packages_bits():
    for n in (2, 3, 4, 10, 21):
        np.testing.assert_array_equal(
            pnn.ClassSimplexCriterion(n).simplex.numpy(),
            np.asarray(jnn.ClassSimplexCriterion(n).simplex))


def test_target_free_criterions_take_no_target():
    """``KLDCriterion`` and ``L1Cost`` are called with the input alone,
    as in the JAX package."""
    mean, lv = _r((4, 3)), _r((4, 3), 1, -1, 1)
    got = pnn.KLDCriterion()(T(torch.from_numpy(mean), torch.from_numpy(lv)))
    want = jnn.KLDCriterion().forward([mean, lv])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    x = _r((3, 2))
    assert pnn.L1Cost()(torch.from_numpy(x)).item() == pytest.approx(
        float(jnn.L1Cost().forward(x)), rel=1e-6)


def test_criterion_backward_is_the_loss_gradient():
    """``Criterion.backward(input, target)`` on a new criterion: the
    gradient with respect to each leaf of a table input."""
    crit = pnn.CosineEmbeddingCriterion(0.2)
    a, b = torch.from_numpy(_r((3, 4))), torch.from_numpy(_r((3, 4), 1))
    y = torch.tensor([1.0, -1.0, -1.0])
    ga, gb = crit.backward([a, b], y)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    crit([a2, b2], y).backward()
    torch.testing.assert_close(ga, a2.grad)
    torch.testing.assert_close(gb, b2.grad)


"""Wide-and-deep recommendation over the sparse training feed
(counterpart of the JAX package's ``examples/wide_and_deep.py``; BigDL's
SparseTensor input path, nn/SparseLinear.scala fed through
dataset/MiniBatch.scala:587's SparseMiniBatch).

The wide side is a large one-hot / cross-feature vector kept sparse end
to end: a ``SparseFeature`` a record, batched by ``SampleToMiniBatch``
into a fixed-nnz padded COO, given to ``SparseLinear`` as a
``torch.sparse_coo_tensor``. The deep side is a small dense MLP; both
heads sum into the class scores (``CAddTable``).

    python -m bigdl_tpu_torch.examples.wide_and_deep --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, PaddingParam, Sample,
                                     SampleToMiniBatch, SparseFeature)
from bigdl_tpu_torch.examples._common import (add_device_flag,
                                              example_device,
                                              seeded_generator)
from bigdl_tpu_torch.optim import (SGD, Evaluator, LocalOptimizer,
                                   Top1Accuracy, max_epoch)

__all__ = ["build_model", "main", "synthetic_interactions"]


def synthetic_interactions(n: int, wide_dim: int, deep_dim: int, seed=0):
    """CTR-style records whose label depends on a few wide crosses and a
    dense profile, so both sides must learn. The true weights come from
    a fixed seed: train and held-out splits share one true model and
    differ in their records. The same ``numpy.random`` calls as the JAX
    example, so one seed gives the same records."""
    truth = np.random.RandomState(1234)
    w_wide = truth.randn(wide_dim) * (truth.rand(wide_dim) < 0.1)
    w_deep = truth.randn(deep_dim)
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(n):
        nnz = rng.randint(1, 6)
        hot = rng.choice(wide_dim, size=nnz, replace=False)
        deep = rng.randn(deep_dim).astype(np.float32)
        score = w_wide[hot].sum() + 0.5 * float(deep @ w_deep)
        label = 1.0 if score > 0 else 2.0
        wide = SparseFeature(hot[:, None], np.ones(nnz, np.float32),
                             (wide_dim,))
        samples.append(Sample([wide, deep], label))
    return samples


def build_model(wide_dim: int, deep_dim: int, n_classes: int = 2,
                generator=None):
    """``ConcatTable(wide, deep) -> CAddTable -> LogSoftMax`` over the
    input table ``(wide COO, deep dense)``: the JAX example's tree."""
    wide = nn.Sequential().add(nn.SelectTable(1)) \
        .add(nn.SparseLinear(wide_dim, n_classes, generator=generator))
    deep = (nn.Sequential().add(nn.SelectTable(2))
            .add(nn.Linear(deep_dim, 16, generator=generator))
            .add(nn.ReLU())
            .add(nn.Linear(16, n_classes, generator=generator)))
    return (nn.Sequential()
            .add(nn.ConcatTable().add(wide).add(deep))
            .add(nn.CAddTable())
            .add(nn.LogSoftMax()))


def main(argv=None):
    ap = argparse.ArgumentParser(description="wide-and-deep on sparse feed")
    ap.add_argument("-n", type=int, default=1024)
    ap.add_argument("--wideDim", type=int, default=200)
    ap.add_argument("--deepDim", type=int, default=8)
    ap.add_argument("-b", "--batchSize", type=int, default=32)
    ap.add_argument("-e", "--maxEpoch", type=int, default=3)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = example_device(args.device)

    # a fixed nnz: every batch has one shape
    pad = PaddingParam(fixed_length=5)
    samples = synthetic_interactions(args.n, args.wideDim, args.deepDim)
    ds = DataSet.array(samples).transform(
        SampleToMiniBatch(args.batchSize, feature_padding=pad,
                          drop_remainder=True))
    model = build_model(args.wideDim, args.deepDim,
                        generator=seeded_generator()).to(device)
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(),
                         batch_size=args.batchSize)
    opt.set_optim_method(SGD(learning_rate=0.5))
    opt.set_end_when(max_epoch(args.maxEpoch))
    opt.optimize()
    print(f"final loss: {opt.driver_state['Loss']:.4f}")

    # held-out accuracy through the Evaluator, on the sparse feed too
    val = synthetic_interactions(256, args.wideDim, args.deepDim, seed=1)
    val_ds = DataSet.array(val).transform(
        SampleToMiniBatch(args.batchSize, feature_padding=pad,
                          drop_remainder=True))
    results = Evaluator(model).test(val_ds, [Top1Accuracy()],
                                    batch_size=args.batchSize)
    acc, _ = results["Top1Accuracy"].result()
    print(f"held-out accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()

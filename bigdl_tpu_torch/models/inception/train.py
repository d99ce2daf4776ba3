"""Inception-v1 ImageNet training recipe (counterpart of
``bigdl_tpu.models.inception.train``; models/inception/Train.scala:34-120;
BASELINE config 4's training side)::

    python -m bigdl_tpu_torch.models.inception.train --synthetic 256 -b 64 -e 1
    python -m bigdl_tpu_torch.models.inception.train --synthetic 64 -e 1 --device cpu

``Inception_v1_NoAuxClassifier`` on ClassNLLCriterion, SGD lr 0.01,
weight decay 1e-4, momentum 0.9, ``Poly(0.5, ceil(rows / batch) *
epochs)``, batch 32, 1 epoch. ``--synthetic N`` draws the JAX recipe's
rows (``RandomState(0)``: ``rand`` then ``randint(1, classNum + 1)``).
``--model``, ``--state``, ``--checkpoint`` and ``--steps-per-sync`` work
as in the other recipes.

Not ported yet: ImageNet from a folder (``-f`` without ``--synthetic``:
``ImageFolderDataSet`` with its color jitter, lighting and the
``--valFolder`` validation, ROADMAP queue 1, item 10) raises
NotImplementedError.
"""
from __future__ import annotations

import math

__all__ = ["main", "synthetic_rows"]

#: seed of the weights' generator: fixed, as the JAX recipe's init key is
_WEIGHT_SEED = 1


def synthetic_rows(n: int, class_num: int, seed: int):
    """``n`` seeded 224 x 224 images and 1-based labels, drawn as the JAX
    recipes draw them (``seed`` 0 trains, 1 tests)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, 3, 224, 224).astype(np.float32)
    lbls = rng.randint(1, class_num + 1, n).astype(np.float32)
    return imgs, lbls


def folder_not_ported():
    raise NotImplementedError(
        "ImageNet from a folder (ImageFolderDataSet, color jitter, "
        "lighting, --valFolder) is not ported yet (ROADMAP queue 1, item "
        "10); use --synthetic N")


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (arrays_to_dataset, base_parser,
                                             load_model_or, report,
                                             wire_optimizer)

    ap = base_parser("Train Inception-v1 on ImageNet")
    ap.add_argument("--weightDecay", type=float, default=1e-4)
    ap.add_argument("--classNum", type=int, default=1000)
    args = ap.parse_args(argv)
    if not args.synthetic:
        folder_not_ported()

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.inception import Inception_v1_NoAuxClassifier
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Poly

    bs = args.batchSize or 32
    epochs = args.maxEpoch or 1
    ds = arrays_to_dataset(*synthetic_rows(args.synthetic, args.classNum, 0),
                           bs)
    model = load_model_or(args, lambda: Inception_v1_NoAuxClassifier(
        args.classNum, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))
    max_iter = int(math.ceil(args.synthetic / bs)) * epochs
    optim = SGD(learning_rate=args.learningRate or 0.01,
                learning_rate_decay=0.0, weight_decay=args.weightDecay,
                momentum=0.9, dampening=0.0,
                learning_rate_schedule=Poly(0.5, max_iter))
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), batch_size=bs)
    wire_optimizer(opt, args, optim, default_epochs=epochs)
    opt.optimize()
    report(opt)
    return model


if __name__ == "__main__":
    main()

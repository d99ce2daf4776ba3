"""Inception-v1 ImageNet training recipe (counterpart of
``bigdl_tpu.models.inception.train``; models/inception/Train.scala:34-120;
BASELINE config 4's training side)::

    python -m bigdl_tpu_torch.models.inception.train --synthetic 256 -b 64 -e 1
    python -m bigdl_tpu_torch.models.inception.train --synthetic 64 -e 1 --device cpu
    python -m bigdl_tpu_torch.models.inception.train -f /imagenet/train \\
        --valFolder /imagenet/val -b 128

``Inception_v1_NoAuxClassifier`` on ClassNLLCriterion, SGD lr 0.01,
weight decay 1e-4, momentum 0.9, ``Poly(0.5, ceil(rows / batch) *
epochs)``, batch 32, 1 epoch. ``-f`` feeds the image folder through the
threaded :class:`~bigdl_tpu_torch.dataset.imagenet.ImageFolderDataSet`
(crop 224 of the shorter side at 256, flips; ``--colorJitter`` and
``--lighting`` off by default), with Top1 and Top5 on ``--valFolder``
every epoch. ``--synthetic N`` draws the JAX recipe's rows
(``RandomState(0)``: ``rand`` then ``randint(1, classNum + 1)``).
``--model``, ``--state``, ``--checkpoint`` and ``--steps-per-sync`` work
as in the other recipes.
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


def main(argv=None):
    import argparse

    import torch

    from bigdl_tpu_torch.models._cli import (arrays_to_dataset, base_parser,
                                             load_model_or, report,
                                             wire_optimizer)

    ap = base_parser("Train Inception-v1 on ImageNet")
    ap.add_argument("--weightDecay", type=float, default=1e-4)
    ap.add_argument("--classNum", type=int, default=1000)
    ap.add_argument("--colorJitter", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="random brightness/contrast/saturation "
                         "(ColorJitter.scala)")
    ap.add_argument("--lighting", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="AlexNet PCA lighting noise (Lighting.scala)")
    ap.add_argument("--valFolder", default=None,
                    help="ImageNet val folder for per-epoch Top1/Top5 "
                         "(Train.scala:100 valSet)")
    args = ap.parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.inception import Inception_v1_NoAuxClassifier
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Poly,
                                       Top1Accuracy, Top5Accuracy)

    bs = args.batchSize or 32
    epochs = args.maxEpoch or 1
    val_ds = None
    if args.synthetic:
        ds = arrays_to_dataset(
            *synthetic_rows(args.synthetic, args.classNum, 0), bs)
        n_train = args.synthetic
    else:
        from bigdl_tpu_torch.dataset import ImageFolderDataSet
        ds = ImageFolderDataSet(args.folder, batch_size=bs, crop=224,
                                scale=256, color_jitter=args.colorJitter,
                                lighting=args.lighting)
        n_train = ds.size()
        if args.valFolder:
            val_ds = ImageFolderDataSet(args.valFolder, batch_size=bs,
                                        crop=224, scale=256)
    model = load_model_or(args, lambda: Inception_v1_NoAuxClassifier(
        args.classNum, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))
    max_iter = int(math.ceil(n_train / bs)) * epochs
    optim = SGD(learning_rate=args.learningRate or 0.01,
                learning_rate_decay=0.0, weight_decay=args.weightDecay,
                momentum=0.9, dampening=0.0,
                learning_rate_schedule=Poly(0.5, max_iter))
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), batch_size=bs)
    wire_optimizer(opt, args, optim, val_ds=val_ds,
                   val_methods=[Top1Accuracy(), Top5Accuracy()],
                   default_epochs=epochs)
    try:
        opt.optimize()
    finally:
        if not args.synthetic:
            ds.close()
    report(opt)
    return model


if __name__ == "__main__":
    main()

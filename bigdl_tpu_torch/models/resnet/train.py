"""ResNet training recipes (counterpart of
``bigdl_tpu.models.resnet.train``; models/resnet/Train.scala:46-99)::

    python -m bigdl_tpu_torch.models.resnet.train -f /path/to/cifar10 --depth 20
    python -m bigdl_tpu_torch.models.resnet.train --synthetic 256 -e 1 --device cpu
    python -m bigdl_tpu_torch.models.resnet.train --dataset imagenet --depth 50 \\
        --synthetic 1024 -b 256 --checkpoint /tmp/ckpt
    python -m bigdl_tpu_torch.models.resnet.train --dataset imagenet \\
        -f /imagenet/train --valFolder /imagenet/val -b 256

CIFAR-10: SGD lr 0.1, weight decay 1e-4, momentum 0.9, nesterov,
``EpochDecay(cifar10_decay)`` (x0.1 at epochs 81 and 122), batch 448,
165 epochs, Top1, Top5 and Loss validation every epoch. ImageNet
(BASELINE config 3): ResNet-50, batch 256, the same SGD under
``EpochDecay(imagenet_decay)`` (x0.1 every 30 epochs), 90 epochs, fed
from the ``-f`` image folder by the threaded
:class:`~bigdl_tpu_torch.dataset.imagenet.ImageFolderDataSet` (crop 224
of the shorter side at 256, flips, ``--colorJitter`` and ``--lighting``
on by default), with Top1 and Top5 on ``--valFolder`` every epoch.
``--synthetic N`` draws N seeded rows as the JAX recipes do (for
ImageNet ``RandomState(0)``: ``rand`` then ``randint(1, classNum + 1)``).
With ``--checkpoint DIR`` a checkpoint is written every epoch and a
second call resumes from the newest one. Prints ``final loss`` as the
JAX recipe does, then the checkpoint it resumed from, the last
validation's scores and the steps' throughput.
"""
from __future__ import annotations

__all__ = ["cifar10_decay", "imagenet_decay", "main"]

#: seed of the weights' generator: fixed, as the JAX recipe's init key is
_WEIGHT_SEED = 1


def cifar10_decay(epoch: int) -> float:
    """resnet/Train.scala:34 cifar10Decay."""
    if epoch >= 122:
        return 2.0
    if epoch >= 81:
        return 1.0
    return 0.0


def imagenet_decay(epoch: int) -> float:
    """fb.resnet's step schedule: x0.1 every 30 epochs."""
    return float(epoch // 30)


def _sgd(args, decay):
    from bigdl_tpu_torch.optim import SGD, EpochDecay
    return SGD(learning_rate=args.learningRate or 0.1,
               learning_rate_decay=0.0, weight_decay=args.weightDecay,
               momentum=0.9, dampening=0.0, nesterov=args.nesterov,
               learning_rate_schedule=EpochDecay(decay))


def _train_imagenet(args, model_of):
    """The ResNet-50 ImageNet recipe: ``--synthetic`` rows, or the
    threaded image-folder feed with ColorJitter and Lighting
    (dataset/image/ColorJitter.scala, Lighting.scala) and ``--valFolder``
    Top1/Top5."""
    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models._cli import (arrays_to_dataset, report,
                                             wire_optimizer)
    from bigdl_tpu_torch.optim import (LocalOptimizer, Top1Accuracy,
                                       Top5Accuracy)

    bs = args.batchSize or 256
    depth = args.depth if args.depth is not None else 50
    val_ds = None
    if args.synthetic:
        rng = np.random.RandomState(0)
        imgs = rng.rand(args.synthetic, 3, 224, 224).astype(np.float32)
        lbls = rng.randint(1, args.classNum + 1,
                           args.synthetic).astype(np.float32)
        ds = arrays_to_dataset(imgs, lbls, bs)
    else:
        from bigdl_tpu_torch.dataset import ImageFolderDataSet
        ds = ImageFolderDataSet(args.folder, batch_size=bs, crop=224,
                                scale=256, color_jitter=args.colorJitter,
                                lighting=args.lighting)
        if args.valFolder:
            val_ds = ImageFolderDataSet(args.valFolder, batch_size=bs,
                                        crop=224, scale=256)
    model = model_of(args.classNum, depth, "ImageNet")
    opt = LocalOptimizer(model, ds, nn.CrossEntropyCriterion(),
                         batch_size=bs)
    wire_optimizer(opt, args, _sgd(args, imagenet_decay), val_ds=val_ds,
                   val_methods=[Top1Accuracy(), Top5Accuracy()],
                   default_epochs=90)
    try:
        opt.optimize()
    finally:
        if not args.synthetic:
            ds.close()
    report(opt)
    return model


def main(argv=None):
    import argparse

    import torch

    from bigdl_tpu_torch.models._cli import (arrays_to_dataset, base_parser,
                                             cifar10_arrays, load_model_or,
                                             report, wire_optimizer)

    ap = base_parser("Train ResNet on CIFAR-10 / ImageNet")
    ap.add_argument("--depth", type=int, default=None,
                    help="default: 20 (cifar10) / 50 (imagenet)")
    ap.add_argument("--weightDecay", type=float, default=1e-4)
    ap.add_argument("--nesterov", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--dataset", choices=("cifar10", "imagenet"),
                    default="cifar10")
    ap.add_argument("--classNum", type=int, default=1000)
    ap.add_argument("--colorJitter", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="ImageNet only: random b/c/s (ColorJitter.scala)")
    ap.add_argument("--lighting", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="ImageNet only: PCA noise (Lighting.scala)")
    ap.add_argument("--valFolder", default=None,
                    help="ImageNet only: val folder for per-epoch "
                         "Top1/Top5")
    args = ap.parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.optim import (LocalOptimizer, Loss, Top1Accuracy,
                                       Top5Accuracy)

    def model_of(classes, depth, dataset):
        return load_model_or(args, lambda: ResNet(
            classes, depth=depth, dataset=dataset, device=args.device,
            generator=torch.Generator().manual_seed(_WEIGHT_SEED)))

    if args.dataset == "imagenet":
        return _train_imagenet(args, model_of)

    bs = args.batchSize or 448
    tr = cifar10_arrays(args.folder, True, args.synthetic)
    va = cifar10_arrays(args.folder, False, args.synthetic)
    model = model_of(10, args.depth or 20, "CIFAR10")
    opt = LocalOptimizer(model, arrays_to_dataset(*tr, bs),
                         nn.CrossEntropyCriterion(), batch_size=bs)
    wire_optimizer(opt, args, _sgd(args, cifar10_decay),
                   val_ds=arrays_to_dataset(*va, bs),
                   val_methods=[Top1Accuracy(), Top5Accuracy(), Loss()],
                   default_epochs=165)
    opt.optimize()
    report(opt)
    return model


if __name__ == "__main__":
    main()

"""VGG CIFAR-10 training recipe (counterpart of
``bigdl_tpu.models.vgg.train``; models/vgg/Train.scala:30-80; BASELINE
config 2)::

    python -m bigdl_tpu_torch.models.vgg.train -f /path/to/cifar10 -b 112
    python -m bigdl_tpu_torch.models.vgg.train --synthetic 256 -e 1 --device cpu

``VggForCifar10`` (dropout and BN) on ClassNLLCriterion, SGD lr 0.01,
weight decay 5e-4, momentum 0.9, ``EpochStep(25, 0.5)``, batch 112, 90
epochs, Top1, Top5 and Loss validation every epoch, as the JAX recipe
runs. ``--model``, ``--state``, ``--checkpoint`` and
``--steps-per-sync`` work as in the other recipes. Prints ``final
loss``, the last validation's scores and the steps' images/s.
"""
from __future__ import annotations

__all__ = ["main"]

#: seed of the weights' generator: fixed, as the JAX recipe's init key is
_WEIGHT_SEED = 1


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (arrays_to_dataset, base_parser,
                                             cifar10_arrays, load_model_or,
                                             report, wire_optimizer)

    ap = base_parser("Train VGG-16 on CIFAR-10")
    ap.add_argument("--weightDecay", type=float, default=5e-4)
    args = ap.parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.optim import (SGD, EpochStep, LocalOptimizer, Loss,
                                       Top1Accuracy, Top5Accuracy)

    bs = args.batchSize or 112
    tr = cifar10_arrays(args.folder, True, args.synthetic)
    va = cifar10_arrays(args.folder, False, args.synthetic)
    model = load_model_or(args, lambda: VggForCifar10(
        10, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))
    optim = SGD(learning_rate=args.learningRate or 0.01,
                learning_rate_decay=0.0, weight_decay=args.weightDecay,
                momentum=0.9, dampening=0.0, nesterov=False,
                learning_rate_schedule=EpochStep(25, 0.5))
    opt = LocalOptimizer(model, arrays_to_dataset(*tr, bs),
                         nn.ClassNLLCriterion(), batch_size=bs)
    wire_optimizer(opt, args, optim,
                   val_ds=arrays_to_dataset(*va, bs),
                   val_methods=[Top1Accuracy(), Top5Accuracy(), Loss()],
                   default_epochs=90)
    opt.optimize()
    report(opt)
    return model


if __name__ == "__main__":
    main()

"""LeNet-5 MNIST training recipe (counterpart of
``bigdl_tpu.models.lenet.train``; models/lenet/Train.scala; BASELINE
config 1)::

    python -m bigdl_tpu_torch.models.lenet.train -f /path/to/mnist -b 12 -e 15
    python -m bigdl_tpu_torch.models.lenet.train --synthetic 256 -e 1 --device cpu

SGD on ClassNLLCriterion with Top1, Top5 and Loss validation every
epoch, as the JAX recipe runs. Prints ``final loss`` as the JAX recipe
does, then the last validation's scores and the training steps'
throughput.

``-g`` trains the Graph form (``LeNet5_graph``, the same weights).
``--model`` starts from a module saved by either package,
``--state`` from a pickled optim-method state, and ``--checkpoint DIR``
writes a checkpoint every epoch and resumes from the newest one there.
"""
from __future__ import annotations

__all__ = ["main"]

#: seed of the weights' generator: fixed, as the JAX recipe's init key is
_WEIGHT_SEED = 1


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (arrays_to_dataset, base_parser,
                                             load_model_or, mnist_arrays,
                                             report, wire_optimizer)

    ap = base_parser("Train LeNet-5 on MNIST")
    ap.add_argument("-g", "--graphModel", action="store_true",
                    help="use the Graph form of LeNet-5")
    args = ap.parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.lenet import LeNet5, LeNet5_graph
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Loss,
                                       Top1Accuracy, Top5Accuracy)

    bs = args.batchSize or 12
    tr = mnist_arrays(args.folder, True, args.synthetic)
    va = mnist_arrays(args.folder, False, args.synthetic)
    build = LeNet5_graph if args.graphModel else LeNet5
    model = load_model_or(args, lambda: build(
        10, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))
    optim = SGD(learning_rate=args.learningRate or 0.05,
                learning_rate_decay=args.learningRateDecay or 0.0)
    opt = LocalOptimizer(model, arrays_to_dataset(*tr, bs),
                         nn.ClassNLLCriterion(), batch_size=bs)
    wire_optimizer(opt, args, optim,
                   val_ds=arrays_to_dataset(*va, bs),
                   val_methods=[Top1Accuracy(), Top5Accuracy(), Loss()],
                   default_epochs=15)
    opt.optimize()
    report(opt)
    return model


if __name__ == "__main__":
    main()

"""MNIST autoencoder training recipe (counterpart of
``bigdl_tpu.models.autoencoder.train``; models/autoencoder/Train.scala)::

    python -m bigdl_tpu_torch.models.autoencoder.train -f /path/to/mnist
    python -m bigdl_tpu_torch.models.autoencoder.train --synthetic 256 -e 1 --device cpu

``Autoencoder(32)`` on ``MSECriterion`` against the input image, Adagrad
lr 0.01, batch 150, 10 epochs, as the JAX recipe runs. ``--model``,
``--state``, ``--checkpoint`` and ``--steps-per-sync`` work as in the
other recipes. Prints ``final loss`` and the steps' images/s.
"""
from __future__ import annotations

__all__ = ["main", "mnist_rows"]

#: seed of the weights' generator: fixed, as the JAX recipe's init key is
_WEIGHT_SEED = 1


def mnist_rows(args, train: bool, batch_size: int):
    """The flattened MNIST split (or ``--synthetic`` rows) as a dataset
    whose target is the input row."""
    import numpy as np

    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models._cli import mnist_arrays

    imgs, _ = mnist_arrays(args.folder, train, args.synthetic)
    flat = imgs.reshape(len(imgs), -1).astype(np.float32)
    samples = [Sample(flat[i], flat[i]) for i in range(len(flat))]
    return DataSet.array(samples).transform(SampleToMiniBatch(batch_size))


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (base_parser, load_model_or,
                                             report, wire_optimizer)

    args = base_parser("Train the MNIST autoencoder").parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.autoencoder import Autoencoder
    from bigdl_tpu_torch.optim import Adagrad, LocalOptimizer

    bs = args.batchSize or 150
    model = load_model_or(args, lambda: Autoencoder(
        32, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))
    optim = Adagrad(learning_rate=args.learningRate or 0.01)
    opt = LocalOptimizer(model, mnist_rows(args, True, bs),
                         nn.MSECriterion(), batch_size=bs)
    wire_optimizer(opt, args, optim, default_epochs=10)
    opt.optimize()
    report(opt)
    return model


if __name__ == "__main__":
    main()

"""MNIST autoencoder evaluation (counterpart of
``bigdl_tpu.models.autoencoder.test``): the reconstruction MSE over the
test split, the training objective at evaluation time::

    python -m bigdl_tpu_torch.models.autoencoder.test -f /path/to/mnist --model DIR
    python -m bigdl_tpu_torch.models.autoencoder.test --synthetic 64 --device cpu

Int8 with ``--quantize``.
"""
from __future__ import annotations

__all__ = ["main"]


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import test_model, test_parser

    args = test_parser("Test the MNIST autoencoder").parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.autoencoder import Autoencoder
    from bigdl_tpu_torch.models.autoencoder.train import (_WEIGHT_SEED,
                                                          mnist_rows)
    from bigdl_tpu_torch.optim import Evaluator, Loss

    bs = args.batchSize or 150
    model = test_model(args, lambda: Autoencoder(
        32, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))
    results = Evaluator(model).test(mnist_rows(args, False, bs),
                                    [Loss(nn.MSECriterion())], batch_size=bs)
    for name, r in results.items():
        print(f"{name}: {r}")
    return results


if __name__ == "__main__":
    main()

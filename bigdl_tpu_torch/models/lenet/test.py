"""LeNet-5 MNIST evaluation (counterpart of
``bigdl_tpu.models.lenet.test``; models/lenet/Test.scala)::

    python -m bigdl_tpu_torch.models.lenet.test --synthetic 256 --device cpu

Top1 and Top5 of a ``--model`` snapshot saved by either package, or of
a freshly built LeNet-5.
"""
from __future__ import annotations

__all__ = ["main"]


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (evaluate_cli, mnist_arrays,
                                             test_parser)
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.lenet.train import _WEIGHT_SEED

    args = test_parser("Test LeNet-5 on MNIST").parse_args(argv)
    return evaluate_cli(args, lambda: LeNet5(
        10, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)),
        mnist_arrays(args.folder, False, args.synthetic))


if __name__ == "__main__":
    main()

"""ResNet CIFAR-10 evaluation (counterpart of
``bigdl_tpu.models.resnet.test``; models/resnet/Test.scala)::

    python -m bigdl_tpu_torch.models.resnet.test --synthetic 256 --device cpu
    python -m bigdl_tpu_torch.models.resnet.test --model DIR -f /path/to/cifar10

Top1 and Top5 of a ``--model`` snapshot saved by either package, or of
a freshly built ResNet.
"""
from __future__ import annotations

__all__ = ["main"]


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (cifar10_arrays, evaluate_cli,
                                             test_parser)
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.models.resnet.train import _WEIGHT_SEED

    ap = test_parser("Test ResNet on CIFAR-10")
    ap.add_argument("--depth", type=int, default=20)
    args = ap.parse_args(argv)
    return evaluate_cli(args, lambda: ResNet(
        10, depth=args.depth, dataset="CIFAR10", device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)),
        cifar10_arrays(args.folder, False, args.synthetic))


if __name__ == "__main__":
    main()

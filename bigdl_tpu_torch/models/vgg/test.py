"""VGG CIFAR-10 evaluation (counterpart of ``bigdl_tpu.models.vgg.test``;
models/vgg/Test.scala)::

    python -m bigdl_tpu_torch.models.vgg.test --model DIR -f /path/to/cifar10
    python -m bigdl_tpu_torch.models.vgg.test --synthetic 256 --device cpu

Top1 and Top5 of a ``--model`` snapshot saved by either package (or of
a freshly built ``VggForCifar10``), int8 with ``--quantize``.
"""
from __future__ import annotations

__all__ = ["main"]


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (cifar10_arrays, evaluate_cli,
                                             test_parser)
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.models.vgg.train import _WEIGHT_SEED

    args = test_parser("Test VGG-16 on CIFAR-10").parse_args(argv)
    return evaluate_cli(args, lambda: VggForCifar10(
        10, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)),
        cifar10_arrays(args.folder, False, args.synthetic))


if __name__ == "__main__":
    main()

"""LeNet-5 MNIST evaluation (counterpart of
``bigdl_tpu.models.lenet.test``; models/lenet/Test.scala)::

    python -m bigdl_tpu_torch.models.lenet.test --synthetic 256 --device cpu

Top1 and Top5 of a ``--model`` snapshot saved by either package, or of
a freshly built LeNet-5 (``-g``: its Graph form).
"""
from __future__ import annotations

__all__ = ["main"]


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (evaluate_cli, mnist_arrays,
                                             test_parser)
    from bigdl_tpu_torch.models.lenet import LeNet5, LeNet5_graph
    from bigdl_tpu_torch.models.lenet.train import _WEIGHT_SEED

    ap = test_parser("Test LeNet-5 on MNIST")
    ap.add_argument("-g", "--graphModel", action="store_true",
                    help="use the Graph form of LeNet-5")
    args = ap.parse_args(argv)
    build = LeNet5_graph if args.graphModel else LeNet5
    return evaluate_cli(args, lambda: build(
        10, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)),
        mnist_arrays(args.folder, False, args.synthetic))


if __name__ == "__main__":
    main()

"""Inception-v1 ImageNet evaluation (counterpart of
``bigdl_tpu.models.inception.test``; models/inception/Test.scala:38-64)::

    python -m bigdl_tpu_torch.models.inception.test --synthetic 16 --classNum 10 --device cpu
    python -m bigdl_tpu_torch.models.inception.test --synthetic 64 --model DIR --quantize

Top1 and Top5 of a ``--model`` snapshot saved by either package (or of
a freshly built ``Inception_v1_NoAuxClassifier``), int8 with
``--quantize``, on ``--synthetic N`` rows drawn as the JAX CLI draws
them (``RandomState(1)``).

Not ported yet: the ImageNet val folder (``-f`` without
``--synthetic``; ROADMAP queue 1, item 10) raises NotImplementedError.
"""
from __future__ import annotations

__all__ = ["main"]


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import evaluate_cli, test_parser
    from bigdl_tpu_torch.models.inception import Inception_v1_NoAuxClassifier
    from bigdl_tpu_torch.models.inception.train import (_WEIGHT_SEED,
                                                        folder_not_ported,
                                                        synthetic_rows)

    ap = test_parser("Test Inception-v1 on ImageNet")
    ap.add_argument("--classNum", type=int, default=1000)
    args = ap.parse_args(argv)
    if not args.synthetic:
        folder_not_ported()
    return evaluate_cli(args, lambda: Inception_v1_NoAuxClassifier(
        args.classNum, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)),
        synthetic_rows(args.synthetic, args.classNum, 1), default_batch=32)


if __name__ == "__main__":
    main()

"""Inception-v1 ImageNet evaluation (counterpart of
``bigdl_tpu.models.inception.test``; models/inception/Test.scala:38-64)::

    python -m bigdl_tpu_torch.models.inception.test --synthetic 16 --classNum 10 --device cpu
    python -m bigdl_tpu_torch.models.inception.test --synthetic 64 --model DIR --quantize
    python -m bigdl_tpu_torch.models.inception.test -f /imagenet/val --model DIR

Top1 and Top5 of a ``--model`` snapshot saved by either package (or of
a freshly built ``Inception_v1_NoAuxClassifier``), int8 with
``--quantize``, on the ``-f`` val folder (center crop 224 of the
shorter side at 256, Test.scala) or on ``--synthetic N`` rows drawn as
the JAX CLI draws them (``RandomState(1)``).
"""
from __future__ import annotations

__all__ = ["main"]


def main(argv=None):
    import torch

    from bigdl_tpu_torch.models._cli import (evaluate_cli, test_model,
                                             test_parser)
    from bigdl_tpu_torch.models.inception import Inception_v1_NoAuxClassifier
    from bigdl_tpu_torch.models.inception.train import (_WEIGHT_SEED,
                                                        synthetic_rows)

    ap = test_parser("Test Inception-v1 on ImageNet")
    ap.add_argument("--classNum", type=int, default=1000)
    args = ap.parse_args(argv)

    def build():
        return Inception_v1_NoAuxClassifier(
            args.classNum, device=args.device,
            generator=torch.Generator().manual_seed(_WEIGHT_SEED))

    if args.synthetic:
        return evaluate_cli(
            args, build, synthetic_rows(args.synthetic, args.classNum, 1),
            default_batch=32)

    from bigdl_tpu_torch.dataset import ImageFolderDataSet
    from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy, Top5Accuracy

    bs = args.batchSize or 32
    model = test_model(args, build)
    ds = ImageFolderDataSet(args.folder, batch_size=bs, crop=224, scale=256)
    results = Evaluator(model).test(
        ds, [Top1Accuracy(), Top5Accuracy()], batch_size=bs)
    for name, r in results.items():
        print(f"{name}: {r}")
    return results


if __name__ == "__main__":
    main()

"""Shared flags and glue of the recipes' entry points (counterpart of
``bigdl_tpu.models._cli``): the reference recipes' ``-f``, ``-b``,
``-e``, ``-r``, ``-d``, ``--maxIterations`` and ``--synthetic N``, plus
the port's ``--device``; MNIST arrays, the in-memory dataset, the
validation wiring and the Test.scala evaluation main.

``--model``, ``--state`` and ``--checkpoint`` are parsed and raise
NotImplementedError: snapshots and checkpoints are ROADMAP queue 1,
item 3. Not ported yet: ``--quantize``, ``--steps-per-sync`` and the
CIFAR-10 arrays.
"""
from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np

__all__ = ["arrays_to_dataset", "base_parser", "evaluate_cli",
           "load_model_or", "mnist_arrays", "wire_optimizer"]


def base_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("-f", "--folder", default="./",
                    help="where the dataset lives")
    ap.add_argument("-b", "--batchSize", type=int, default=None)
    ap.add_argument("-e", "--maxEpoch", type=int, default=None)
    ap.add_argument("-r", "--learningRate", type=float, default=None)
    ap.add_argument("-d", "--learningRateDecay", type=float, default=None)
    ap.add_argument("--model", default=None,
                    help="model snapshot to resume/test (not ported yet)")
    ap.add_argument("--state", default=None,
                    help="optim-method state snapshot (not ported yet)")
    ap.add_argument("--checkpoint", default=None,
                    help="directory to write checkpoints (not ported yet)")
    ap.add_argument("--maxIterations", type=int, default=None,
                    help="stop after N iterations (overrides maxEpoch)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train on N seeded synthetic samples instead of "
                    "-f data")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def _not_ported(flag: str):
    return NotImplementedError(
        f"{flag}: model and optim-method snapshots and checkpoints are not "
        f"ported yet (ROADMAP queue 1, item 3)")


def load_model_or(args, build):
    """The fresh model from ``build()``; a ``--model`` snapshot
    raises."""
    if getattr(args, "model", None):
        raise _not_ported("--model")
    return build()


def wire_optimizer(opt, args, optim_method, val_ds=None, val_methods=None,
                   default_epochs: int = 1):
    """set_optim_method / set_validation (every epoch) / set_end_when in
    the reference shape."""
    from bigdl_tpu_torch.optim import every_epoch, max_epoch, max_iteration

    for flag in ("state", "checkpoint"):
        if getattr(args, flag, None):
            raise _not_ported(f"--{flag}")
    opt.set_optim_method(optim_method)
    if val_ds is not None and val_methods:
        opt.set_validation(every_epoch(), val_ds, val_methods)
    if args.maxIterations:
        opt.set_end_when(max_iteration(args.maxIterations))
    else:
        opt.set_end_when(max_epoch(args.maxEpoch or default_epochs))
    return opt


def mnist_arrays(folder: str, train: bool,
                 synthetic: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST idx files under ``folder`` -> normalized ``[N, 1, 28, 28]``
    images and 1-based labels (lenet/Utils.scala's train and test mean
    and std), or with ``synthetic`` N seeded uniform rows as the JAX
    recipe draws them. Without the files the recipe exits and names
    ``--synthetic``: nothing is downloaded."""
    if synthetic:
        from bigdl_tpu_torch.tools.synthetic import (SEED_EVAL, SEED_TRAIN,
                                                     image_batch)
        return image_batch(synthetic, (1, 28, 28), 10,
                           seed=SEED_TRAIN if train else SEED_EVAL)
    from bigdl_tpu_torch.dataset.image import load_mnist

    prefix = "train" if train else "t10k"
    paths = []
    for kind in ("images-idx3", "labels-idx1"):
        path = os.path.join(folder, f"{prefix}-{kind}-ubyte")
        if not os.path.exists(path):
            path += ".gz"
        if not os.path.exists(path):
            raise SystemExit(
                f"MNIST not found under '{folder}' ({prefix}-{kind}-ubyte"
                f"[.gz]); stage the idx files there, or use --synthetic N")
        paths.append(path)
    imgs, lbls = load_mnist(*paths)
    mean, std = ((0.13066047, 0.3081078) if train
                 else (0.13251461, 0.31048024))
    return ((imgs / 255.0 - mean) / std).astype(np.float32), lbls


def arrays_to_dataset(imgs, lbls, batch_size: int):
    """One Sample per row, batched by ``batch_size``."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    samples = [Sample(imgs[i], lbls[i]) for i in range(len(imgs))]
    return DataSet.array(samples).transform(SampleToMiniBatch(batch_size))


def evaluate_cli(args, build, val_data, default_batch: int = 128):
    """The Test.scala main: Top1 and Top5 of the built model on
    ``val_data``, printed and returned."""
    from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy, Top5Accuracy

    model = load_model_or(args, build).evaluate()
    imgs, lbls = val_data
    bs = args.batchSize or default_batch
    ds = arrays_to_dataset(imgs, lbls, bs)
    results = Evaluator(model).test(
        ds, [Top1Accuracy(), Top5Accuracy()], batch_size=bs)
    for name, r in results.items():
        print(f"{name}: {r}")
    return results

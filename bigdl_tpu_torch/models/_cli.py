"""Shared flags and glue of the recipes' entry points (counterpart of
``bigdl_tpu.models._cli``): the reference recipes' ``-f``, ``-b``,
``-e``, ``-r``, ``-d``, ``--maxIterations`` and ``--synthetic N``, plus
the port's ``--device``; the snapshots: ``--model`` (a module saved by
either package's ``save_module``), ``--state`` (a pickled optim-method
state) and ``--checkpoint`` (a checkpoint every epoch, and resume from
the newest there), with ``--overWrite`` (one checkpoint name, which the
JAX recipes parse and ignore); ``--steps-per-sync K``
(``Optimizer.set_steps_per_sync``: K steps a host sync, one CUDA graph a
window on the card); the test mains' ``--quantize`` (:func:`test_parser`;
they score the int8 rewrite,
:func:`bigdl_tpu_torch.nn.quantized.quantize`); MNIST and CIFAR-10
arrays, the in-memory dataset, the validation wiring and the Test.scala
evaluation main.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Tuple

import numpy as np

__all__ = ["arrays_to_dataset", "base_parser", "cifar10_arrays",
           "evaluate_cli", "load_model_or", "mnist_arrays", "report",
           "test_model", "test_parser", "wire_optimizer"]


def base_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("-f", "--folder", default="./",
                    help="where the dataset lives")
    ap.add_argument("-b", "--batchSize", type=int, default=None)
    ap.add_argument("-e", "--maxEpoch", type=int, default=None)
    ap.add_argument("-r", "--learningRate", type=float, default=None)
    ap.add_argument("-d", "--learningRateDecay", type=float, default=None)
    ap.add_argument("--model", default=None,
                    help="model snapshot to resume/test")
    ap.add_argument("--state", default=None,
                    help="optim-method state snapshot to resume")
    ap.add_argument("--checkpoint", default=None,
                    help="directory to write checkpoints")
    ap.add_argument("--overWrite", action="store_true",
                    help="overwrite checkpoint files")
    ap.add_argument("--maxIterations", type=int, default=None,
                    help="stop after N iterations (overrides maxEpoch)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train on N seeded synthetic samples instead of "
                    "-f data")
    ap.add_argument("--steps-per-sync", type=int, default=1, metavar="K",
                    help="run K train steps a host sync, one CUDA graph "
                    "a window on the card (Optimizer.set_steps_per_sync)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def test_parser(desc: str) -> argparse.ArgumentParser:
    """:func:`base_parser` plus the test mains' ``--quantize``."""
    ap = base_parser(desc)
    ap.add_argument("--quantize", action="store_true",
                    help="int8-quantize the model before evaluation "
                    "(AbstractModule.quantize)")
    return ap


def load_model_or(args, build):
    """The ``--model`` snapshot on ``--device``, else ``build()``."""
    if getattr(args, "model", None):
        from bigdl_tpu_torch.utils.serialization import load_module
        return load_module(args.model, device=args.device)
    return build()


def wire_optimizer(opt, args, optim_method, val_ds=None, val_methods=None,
                   default_epochs: int = 1):
    """``--state``, set_optim_method, ``--checkpoint`` (every epoch) /
    set_validation (every epoch) / set_end_when in the reference
    shape."""
    from bigdl_tpu_torch.optim import every_epoch, max_epoch, max_iteration

    if args.state:
        with open(args.state, "rb") as f:
            optim_method.load_state(pickle.load(f))
    opt.set_optim_method(optim_method)
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, every_epoch())
        if args.overWrite:
            opt.overwrite_checkpoint()
    if val_ds is not None and val_methods:
        opt.set_validation(every_epoch(), val_ds, val_methods)
    if args.maxIterations:
        opt.set_end_when(max_iteration(args.maxIterations))
    else:
        opt.set_end_when(max_epoch(args.maxEpoch or default_epochs))
    if getattr(args, "steps_per_sync", 1) != 1:
        # set_steps_per_sync rejects 0 or a negative K loudly
        opt.set_steps_per_sync(args.steps_per_sync)
    return opt


def report(opt) -> None:
    """What the recipes print after ``optimize()``: ``final loss`` as the
    JAX recipes print it, the checkpoint a run resumed from, the last
    validation's scores and the training steps' throughput."""
    print(f"final loss: {opt.driver_state['Loss']:.4f}")
    if opt.resumed_from is not None:
        print(f"resumed from {opt.resumed_from['path']} at neval "
              f"{opt.resumed_from['neval']}")
    if opt.validation_history:
        last = opt.validation_history[-1]
        print("validation: " + " ".join(
            f"{k} {v:.6f}" for k, v in last.items()))
    rows = sum(h["rows"] for h in opt.history)
    seconds = sum(h["seconds"] for h in opt.history)
    print(f"throughput: {rows / max(seconds, 1e-9):.1f} images/s over "
          f"{len(opt.history)} steps")


def mnist_arrays(folder: str, train: bool,
                 synthetic: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST idx files under ``folder`` -> normalized ``[N, 1, 28, 28]``
    images and 1-based labels (lenet/Utils.scala's train and test mean
    and std), or with ``synthetic`` N seeded uniform rows as the JAX
    recipe draws them. Without the image file the recipe downloads the
    idx files into ``folder`` as the JAX recipe does
    (:func:`bigdl_tpu_torch.dataset.fetch.mnist_read_data_sets`); when
    that fails it exits and names ``--synthetic``."""
    if synthetic:
        from bigdl_tpu_torch.tools.synthetic import (SEED_EVAL, SEED_TRAIN,
                                                     image_batch)
        return image_batch(synthetic, (1, 28, 28), 10,
                           seed=SEED_TRAIN if train else SEED_EVAL)
    from bigdl_tpu_torch.dataset.image import load_mnist

    prefix = "train" if train else "t10k"
    img_path = os.path.join(folder, f"{prefix}-images-idx3-ubyte")
    if not os.path.exists(img_path) and \
            not os.path.exists(img_path + ".gz"):
        # the reference's recipes materialize their corpus from nothing
        # (pyspark/bigdl/models/lenet/lenet5.py:24-30)
        from bigdl_tpu_torch.dataset import fetch
        try:
            imgs, lbls = fetch.mnist_read_data_sets(
                folder, "train" if train else "test")
        except Exception as e:
            raise SystemExit(
                f"MNIST not found under '{folder}' and auto-download "
                f"failed ({type(e).__name__}: {e}). Pre-stage the idx "
                "files there, or use --synthetic N.")
        imgs = imgs[:, None, :, :].astype(np.float32)
        lbls = (lbls + 1).astype(np.float32)  # 1-based criterion labels
    else:
        paths = []
        for kind in ("images-idx3", "labels-idx1"):
            path = os.path.join(folder, f"{prefix}-{kind}-ubyte")
            if not os.path.exists(path):
                path += ".gz"
            paths.append(path)
        imgs, lbls = load_mnist(*paths)
    mean, std = ((0.13066047, 0.3081078) if train
                 else (0.13251461, 0.31048024))
    return ((imgs / 255.0 - mean) / std).astype(np.float32), lbls


def cifar10_arrays(folder: str, train: bool, synthetic: int = 0):
    """CIFAR-10 binary batches under ``folder`` -> normalized ``[N, 3,
    32, 32]`` images and 1-based labels (the vgg and resnet recipes'
    per-channel statistics), or with ``synthetic`` N seeded uniform rows
    as the JAX recipe draws them."""
    if synthetic:
        from bigdl_tpu_torch.tools.synthetic import (SEED_EVAL, SEED_TRAIN,
                                                     image_batch)
        return image_batch(synthetic, (3, 32, 32), 10,
                           seed=SEED_TRAIN if train else SEED_EVAL)
    from bigdl_tpu_torch.dataset.image import load_cifar10
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
        else ["test_batch.bin"]
    paths = [os.path.join(folder, n) for n in names]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise SystemExit(
            f"CIFAR-10 not found under '{folder}' ({missing[0]}); stage the "
            f"binary batches there, or use --synthetic N")
    imgs, lbls = load_cifar10(paths)
    mean = np.array([125.3, 123.0, 113.9], np.float32).reshape(3, 1, 1)
    std = np.array([63.0, 62.1, 66.7], np.float32).reshape(3, 1, 1)
    return ((imgs - mean) / std).astype(np.float32), lbls


def arrays_to_dataset(imgs, lbls, batch_size: int):
    """One Sample per row, batched by ``batch_size``."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    samples = [Sample(imgs[i], lbls[i]) for i in range(len(imgs))]
    return DataSet.array(samples).transform(SampleToMiniBatch(batch_size))


def test_model(args, build):
    """The ``--model`` snapshot or ``build()``, in evaluation mode, and
    its int8 rewrite with ``--quantize``."""
    model = load_model_or(args, build).evaluate()
    if args.quantize:
        from bigdl_tpu_torch.nn.quantized import quantize
        model = quantize(model)
    return model


def evaluate_cli(args, build, val_data, default_batch: int = 128):
    """The Test.scala main: Top1 and Top5 of the built model (int8 with
    ``--quantize``) on ``val_data``, printed and returned."""
    from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy, Top5Accuracy

    model = test_model(args, build)
    imgs, lbls = val_data
    bs = args.batchSize or default_batch
    ds = arrays_to_dataset(imgs, lbls, bs)
    results = Evaluator(model).test(
        ds, [Top1Accuracy(), Top5Accuracy()], batch_size=bs)
    for name, r in results.items():
        print(f"{name}: {r}")
    return results

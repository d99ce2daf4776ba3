"""PTB word-level language model (counterpart of the JAX package's
``examples/language_model.py``; BigDL example/languagemodel,
PTBWordLM.scala:40-120): the stacked-LSTM ``PTBModel``, Adagrad,
``TimeDistributedCriterion(CrossEntropyCriterion)`` and a validation
perplexity every epoch.

The defaults are the "small" PTB configuration of Zaremba et al. 2014,
which PTBWordLM.scala takes: a 10,000-word vocabulary, 200 hidden
units, 2 layers, 20 steps, batch 20, Adagrad at 0.1.

    python -m bigdl_tpu_torch.examples.language_model -f DIR --device cpu
    python -m bigdl_tpu_torch.examples.language_model --synthetic 4000 \
        --device cpu

``-f DIR`` reads ``DIR/train.txt`` and ``DIR/valid.txt`` (PTB text);
nothing is downloaded.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, Sample, SampleToMiniBatch,
                                     load_ptb, ptb_arrays)
from bigdl_tpu_torch.examples._common import (add_device_flag,
                                              example_device,
                                              seeded_generator)
from bigdl_tpu_torch.models import PTBModel
from bigdl_tpu_torch.optim import (Adagrad, LocalOptimizer, Loss,
                                   every_epoch, max_epoch, max_iteration)

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description="PTB word LM (PTBWordLM)")
    ap.add_argument("-f", "--folder", default="./",
                    help="directory with train.txt / valid.txt")
    ap.add_argument("-b", "--batchSize", type=int, default=20)
    ap.add_argument("-e", "--maxEpoch", type=int, default=2)
    ap.add_argument("--vocabSize", type=int, default=10000)
    ap.add_argument("--hiddenSize", type=int, default=200)
    ap.add_argument("--numLayers", type=int, default=2)
    ap.add_argument("--numSteps", type=int, default=20)
    ap.add_argument("--keepProb", type=float, default=2.0,
                    help="<1 enables dropout (PTBModel.scala keepProb)")
    ap.add_argument("--learningRate", type=float, default=0.1)
    ap.add_argument("--maxIterations", type=int, default=None)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train on an N-token synthetic stream")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = example_device(args.device)

    if args.synthetic:
        rng = np.random.RandomState(0)
        vocab = min(args.vocabSize, 50)
        # a noisy repeating pattern (90% the pattern); the validation
        # split is a fresh 2000-token continuation (the same pattern,
        # other noise), so it measures generalization, not memorization
        n = args.synthetic + 2000
        base = np.tile(np.arange(1, vocab + 1), n // vocab + 1)[:n]
        noise = rng.randint(1, vocab + 1, n)
        keep = rng.rand(n) < 0.9
        full = np.where(keep, base, noise).astype(np.float32)
        stream, val_stream = full[:args.synthetic], full[args.synthetic:]
    else:
        splits, d = load_ptb(
            os.path.join(args.folder, "train.txt"),
            vocab_size=args.vocabSize,
            valid_path=os.path.join(args.folder, "valid.txt"))
        stream, vocab = splits["train"], d.vocab_size()
        val_stream = splits.get("valid")
        if val_stream is None:
            print("warning: no valid.txt found — skipping validation")

    def to_ds(token_stream):
        x, y = ptb_arrays(token_stream, args.batchSize, args.numSteps)
        return DataSet.array([Sample(x[i], y[i]) for i in range(len(x))]) \
            .transform(SampleToMiniBatch(args.batchSize))

    model = PTBModel(vocab, args.hiddenSize, vocab,
                     num_layers=args.numLayers, keep_prob=args.keepProb,
                     device=device, generator=seeded_generator())
    # size_average=True: the loss is the per-token cross entropy, so
    # exp(loss) is the perplexity (the JAX example's choice; the
    # reference trains on the step-summed form, PTBWordLM.scala:91)
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(),
                                       size_average=True)
    opt = LocalOptimizer(model, to_ds(stream), crit,
                         batch_size=args.batchSize)
    opt.set_optim_method(Adagrad(learning_rate=args.learningRate))
    if val_stream is not None:
        opt.set_validation(every_epoch(), to_ds(val_stream), [Loss(crit)])
    if args.maxIterations:
        opt.set_end_when(max_iteration(args.maxIterations))
    else:
        opt.set_end_when(max_epoch(args.maxEpoch))
    opt.optimize()
    loss = opt.driver_state["Loss"]
    val = opt.driver_state.get("score")
    print(f"train loss {loss:.4f} perplexity {np.exp(loss):.2f}")
    if val is not None:
        print(f"valid loss {val:.4f} perplexity {np.exp(val):.2f}")
    return opt.driver_state


if __name__ == "__main__":
    main()

"""Text classification (counterpart of the JAX package's
``examples/text_classification.py``; BigDL example/textclassification,
TextClassifier.scala: an embedding and a CNN over 20 Newsgroups).

The pipeline: tokenize -> Dictionary -> id sequences -> LookupTable ->
TemporalConvolution -> max over time -> Linear -> LogSoftMax.

    python -m bigdl_tpu_torch.examples.text_classification \
        --synthetic 400 --device cpu
    python -m bigdl_tpu_torch.examples.text_classification -f DIR \
        --classes 20 --device cpu
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, Dictionary, Sample,
                                     SampleToMiniBatch, tokenize)
from bigdl_tpu_torch.examples._common import (add_device_flag,
                                              example_device,
                                              seeded_generator)
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Top1Accuracy,
                                   every_epoch, max_epoch)

__all__ = ["build_model", "encode_text_ids", "load_texts", "main",
           "synthetic_corpus"]


def encode_text_ids(tokens, dictionary, seq_len: int):
    """Tokens as ``seq_len`` float ids (1-based), truncated, padded with
    the last id (or the unknown word's index when empty)."""
    v = dictionary.vocab_size()
    ids = [dictionary.get_index(w) for w in tokens][:seq_len]
    ids += [ids[-1] if ids else v] * (seq_len - len(ids))
    return np.asarray(ids, np.float32)


def build_model(vocab_size: int, embed_dim: int, class_num: int,
                generator=None):
    """``LookupTable -> TemporalConvolution(E, 128, 5) -> ReLU ->
    Max(2, 3) -> Linear(128, C) -> LogSoftMax``: the JAX example's
    tree."""
    m = nn.Sequential()
    m.add(nn.LookupTable(vocab_size, embed_dim, generator=generator))
    m.add(nn.TemporalConvolution(embed_dim, 128, 5, generator=generator))
    m.add(nn.ReLU())
    m.add(nn.Max(2, 3))                                  # over time
    m.add(nn.Linear(128, class_num, generator=generator))
    m.add(nn.LogSoftMax())
    return m


def synthetic_corpus(n, classes, rng):
    """Class-correlated word streams: class c prefers words c*40 ..
    c*40+39 (the JAX example's draws)."""
    texts, labels = [], []
    for i in range(n):
        c = i % classes
        base = ["w%d" % (c * 40 + int(v)) for v in rng.randint(0, 40, 30)]
        noise = ["w%d" % int(v) for v in rng.randint(0, classes * 40, 10)]
        words = list(rng.permutation(base + noise))
        texts.append(" ".join(words))
        labels.append(float(c + 1))
    return texts, labels


def load_texts(folder: str):
    """``folder/<class>/<file>`` documents: ``(texts, labels, classes)``,
    classes in sorted order, labels 1-based."""
    texts, labels = [], []
    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    for ci, cls in enumerate(classes):
        cdir = os.path.join(folder, cls)
        for fn in sorted(os.listdir(cdir)):
            with open(os.path.join(cdir, fn), errors="replace") as f:
                texts.append(f.read())
            labels.append(float(ci + 1))
    return texts, labels, len(classes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--folder", default=None,
                    help="folder of <class>/<file>.txt documents")
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("-b", "--batchSize", type=int, default=32)
    ap.add_argument("-e", "--maxEpoch", type=int, default=5)
    ap.add_argument("--vocabSize", type=int, default=5000)
    ap.add_argument("--seqLen", type=int, default=40)
    ap.add_argument("--embedDim", type=int, default=32)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = example_device(args.device)

    rng = np.random.RandomState(0)
    if args.synthetic:
        texts, labels = synthetic_corpus(args.synthetic, args.classes, rng)
    else:
        texts, labels, args.classes = load_texts(args.folder)

    token_lists = [tokenize(t) for t in texts]
    d = Dictionary(token_lists, vocab_size=args.vocabSize)
    v = d.vocab_size()

    x = np.stack([encode_text_ids(t, d, args.seqLen) for t in token_lists])
    y = np.asarray(labels, np.float32)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_val = max(1, len(x) // 5)
    ds = DataSet.array([Sample(a, t) for a, t in
                        zip(x[n_val:], y[n_val:])]) \
        .transform(SampleToMiniBatch(args.batchSize))
    val = DataSet.array([Sample(a, t) for a, t in
                         zip(x[:n_val], y[:n_val])])

    model = build_model(v + 1, args.embedDim, args.classes,
                        generator=seeded_generator()).to(device)
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(),
                         batch_size=args.batchSize)
    opt.set_optim_method(SGD(learning_rate=0.5))
    opt.set_end_when(max_epoch(args.maxEpoch))
    opt.set_validation(every_epoch(), val, [Top1Accuracy()])
    opt.optimize()
    print(f"final loss {opt.driver_state['Loss']:.4f} "
          f"val score {opt.driver_state.get('score', float('nan')):.4f}")
    return opt.driver_state


if __name__ == "__main__":
    main()

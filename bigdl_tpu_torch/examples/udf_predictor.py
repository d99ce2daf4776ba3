"""A trained text classifier served as a predict function over raw
strings (counterpart of the JAX package's ``examples/udf_predictor.py``;
BigDL example/udfpredictor, DataframePredictor.scala:25, serves one as a
Spark SQL UDF). Without Spark, the analogue is a plain function over a
column of strings, usable from any dataframe library (``pandas``'s
``apply`` and the like).

    python -m bigdl_tpu_torch.examples.udf_predictor --demo --device cpu
"""
from __future__ import annotations

import argparse
from typing import Callable, List, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, Dictionary, Sample,
                                     SampleToMiniBatch, tokenize)
from bigdl_tpu_torch.examples._common import (add_device_flag,
                                              example_device,
                                              seeded_generator)
from bigdl_tpu_torch.examples.text_classification import (build_model,
                                                          encode_text_ids,
                                                          synthetic_corpus)
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_epoch

__all__ = ["main", "make_text_udf"]


def make_text_udf(model, dictionary, seq_len: int) -> Callable:
    """``predict(texts) -> 1-based class labels``: the closure holds the
    trained model (put in evaluation mode) and the vocabulary, as the
    reference broadcasts them. The forward and the argmax run on the
    model's device; only the labels come back to the host."""
    model.evaluate()
    device = next(model.parameters()).device

    def predict(texts: Sequence[str]) -> List[int]:
        ids = np.stack([encode_text_ids(tokenize(t), dictionary, seq_len)
                        for t in texts])
        with torch.no_grad():
            out = model(torch.from_numpy(ids).to(device))
        return (out.argmax(-1) + 1).tolist()

    return predict


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--demo", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if not args.demo:
        ap.print_help()
        return None
    device = example_device(args.device)

    # train a small classifier on the synthetic corpus, then serve it
    rng = np.random.RandomState(0)
    texts, labels = synthetic_corpus(200, 2, rng)
    token_lists = [tokenize(t) for t in texts]
    d = Dictionary(token_lists, vocab_size=200)
    seq_len = 40

    x = np.stack([encode_text_ids(t, d, seq_len) for t in token_lists])
    y = np.asarray(labels, np.float32)
    ds = DataSet.array([Sample(a, t) for a, t in zip(x, y)]) \
        .transform(SampleToMiniBatch(32))
    model = build_model(d.vocab_size() + 1, 16, 2,
                        generator=seeded_generator()).to(device)
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), batch_size=32)
    opt.set_optim_method(SGD(learning_rate=0.5))
    opt.set_end_when(max_epoch(6))
    opt.optimize()

    udf = make_text_udf(model, d, seq_len)
    demo_texts, demo_labels = synthetic_corpus(8, 2,
                                               np.random.RandomState(7))
    preds = udf(demo_texts)
    hits = sum(int(p == int(t)) for p, t in zip(preds, demo_labels))
    print(f"udf predictions: {preds} (labels "
          f"{[int(t) for t in demo_labels]}, {hits}/8 correct)")
    return preds


if __name__ == "__main__":
    main()

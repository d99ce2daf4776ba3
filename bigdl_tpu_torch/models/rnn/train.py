"""RNN language-model training recipe (counterpart of
``bigdl_tpu.models.rnn.train``; models/rnn/Train.scala:60-133; BASELINE
config 5 with ``--ptb``)::

    python -m bigdl_tpu_torch.models.rnn.train -f dir_with_train.txt
    python -m bigdl_tpu_torch.models.rnn.train --synthetic 2000 -e 2 \\
        --device cpu

The corpus is ``-f``'s ``train.txt`` through the PTB reader and its
Dictionary (``--vocabSize`` words; written to ``--checkpoint``'s
``dictionary.json``, which the test main reads), or the JAX recipe's
seeded ``--synthetic N`` id stream; ``ptb_arrays`` cuts it into
``--numSteps`` windows. The model is ``WordRNN`` (``--hiddenSize``), or
with ``--ptb`` the two-layer LSTM ``PTBModel``; SGD (``-r``, default
0.1; ``-d``, ``--momentum``, ``--weightDecay``) on
``TimeDistributedCriterion(CrossEntropyCriterion())``. Prints ``final
loss`` and ``perplexity`` as the JAX recipe does: the loss is the sum
over the window's steps of the per-step means, and the perplexity its
``exp`` (the reference's scale). ``--model``, ``--state`` and
``--checkpoint`` work as in the other recipes. A missing corpus is
downloaded into ``-f`` as the JAX recipe does
(:func:`bigdl_tpu_torch.dataset.fetch.get_text_corpus`); when that fails
the recipe exits and names ``--synthetic``.
"""
from __future__ import annotations

import os

__all__ = ["main"]

#: seed of the weights' generator: fixed, as the JAX recipe's init key is
_WEIGHT_SEED = 1


def main(argv=None):
    import numpy as np
    import torch

    from bigdl_tpu_torch.models._cli import (arrays_to_dataset, base_parser,
                                             load_model_or, wire_optimizer)

    ap = base_parser("Train the RNN language model")
    ap.add_argument("--vocabSize", type=int, default=4000)
    ap.add_argument("--hiddenSize", type=int, default=40)
    ap.add_argument("--numSteps", type=int, default=20)
    ap.add_argument("--ptb", action="store_true",
                    help="use the stacked-LSTM PTBModel instead of "
                    "SimpleRNN")
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--weightDecay", type=float, default=0.0)
    args = ap.parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.text import load_ptb, ptb_arrays
    from bigdl_tpu_torch.models.rnn import PTBModel, WordRNN
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    bs = args.batchSize or 32
    if args.synthetic:
        rng = np.random.RandomState(0)
        stream = rng.randint(1, args.vocabSize + 1,
                             args.synthetic).astype(np.float32)
        vocab = args.vocabSize
    else:
        train_txt = args.folder if os.path.isfile(args.folder) else \
            os.path.join(args.folder, "train.txt")
        if not os.path.exists(train_txt):
            # recipes run from nothing on a networked host (the
            # reference's readme download step, Train.scala:60-133)
            from bigdl_tpu_torch.dataset import fetch
            try:
                train_txt = fetch.get_text_corpus(args.folder)
            except Exception as e:
                raise SystemExit(
                    f"no corpus at '{train_txt}' and auto-download "
                    f"failed ({type(e).__name__}: {e}). Pre-stage a "
                    "train.txt there, or use --synthetic N.")
        splits, d = load_ptb(train_txt, vocab_size=args.vocabSize)
        stream, vocab = splits["train"], d.vocab_size()
        if args.checkpoint:
            os.makedirs(args.checkpoint, exist_ok=True)
            d.save(os.path.join(args.checkpoint, "dictionary.json"))
    x, y = ptb_arrays(stream, bs, args.numSteps)
    ds = arrays_to_dataset(x, y, bs)

    def build():
        g = dict(device=args.device,
                 generator=torch.Generator().manual_seed(_WEIGHT_SEED))
        if args.ptb:
            return PTBModel(vocab, args.hiddenSize, vocab, **g)
        return WordRNN(vocab, args.hiddenSize, **g)

    model = load_model_or(args, build)
    optim = SGD(learning_rate=args.learningRate or 0.1,
                learning_rate_decay=args.learningRateDecay or 0.0,
                weight_decay=args.weightDecay, momentum=args.momentum)
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())
    opt = LocalOptimizer(model, ds, crit, batch_size=bs)
    wire_optimizer(opt, args, optim, default_epochs=2)
    opt.optimize()
    loss = opt.driver_state["Loss"]
    print(f"final loss: {loss:.4f} perplexity: {np.exp(loss):.2f}")
    if opt.resumed_from is not None:
        print(f"resumed from {opt.resumed_from['path']} at neval "
              f"{opt.resumed_from['neval']}")
    return model


if __name__ == "__main__":
    main()

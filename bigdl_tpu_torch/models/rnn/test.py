"""RNN language-model evaluation and generation (counterpart of
``bigdl_tpu.models.rnn.test``; models/rnn/Test.scala:46-137)::

    python -m bigdl_tpu_torch.models.rnn.test -f dir_with_test.txt \\
        --model snap
    python -m bigdl_tpu_torch.models.rnn.test --synthetic 800 \\
        --numOfWords 5 --device cpu

Scores ``test.txt`` (its words indexed by ``--dictionary``, or the
``dictionary.json`` beside it, which the train main saved; without one
a Dictionary of the test file itself), or the JAX recipe's seeded
``--synthetic N`` id stream, with ``Loss(TimeDistributedCriterion(
CrossEntropyCriterion()))`` over ``--numSteps`` windows (Test.scala:
55-90) and prints each result and ``perplexity``, ``exp`` of the loss.
With ``--numOfWords N`` it instead completes the first batch's windows
by feeding back the last step's argmax N times and prints the first
four rows (Test.scala:91-137). ``--model`` scores a snapshot of either
package (``WordRNN`` or ``PTBModel``), else a freshly built ``WordRNN``;
``--quantize`` scores the int8 rewrite, which leaves a recurrent model
float, as the JAX package's does (``nn/quantized.quantize``).
"""
from __future__ import annotations

import os

__all__ = ["main"]


def _test_stream(args):
    """The evaluation id stream and the vocabulary size."""
    import numpy as np

    from bigdl_tpu_torch.dataset.text import Dictionary, load_ptb, read_words

    if args.synthetic:
        rng = np.random.RandomState(1)
        return rng.randint(1, args.vocabSize + 1,
                           args.synthetic).astype(np.float32), args.vocabSize
    test_txt = args.folder if os.path.isfile(args.folder) else \
        os.path.join(args.folder, "test.txt")
    if not os.path.exists(test_txt):
        raise SystemExit(f"no corpus at '{test_txt}'. Stage a test.txt "
                         f"there, or use --synthetic N")
    dict_path = args.dictionary or os.path.join(
        os.path.dirname(test_txt), "dictionary.json")
    if os.path.exists(dict_path):
        d = Dictionary.load(dict_path)
        stream = np.asarray([d.get_index(w) for w in read_words(test_txt)],
                            np.float32)
        return stream, d.vocab_size()
    splits, d = load_ptb(test_txt, vocab_size=args.vocabSize)
    return splits["train"], d.vocab_size()


def main(argv=None):
    import numpy as np
    import torch

    from bigdl_tpu_torch.models._cli import (arrays_to_dataset, test_model,
                                             test_parser)
    from bigdl_tpu_torch.models.rnn.train import _WEIGHT_SEED

    ap = test_parser("Test the RNN language model")
    ap.add_argument("--vocabSize", type=int, default=4000)
    ap.add_argument("--hiddenSize", type=int, default=40)
    ap.add_argument("--numSteps", type=int, default=20)
    ap.add_argument("--dictionary", default=None,
                    help="dictionary.json saved by the train main")
    ap.add_argument("--numOfWords", type=int, default=None,
                    help="generate this many words per seed sentence "
                    "instead of evaluating the loss")
    args = ap.parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.text import ptb_arrays
    from bigdl_tpu_torch.models.rnn import WordRNN
    from bigdl_tpu_torch.optim import Evaluator, Loss

    bs = args.batchSize or 8
    stream, vocab = _test_stream(args)
    x, y = ptb_arrays(stream, bs, args.numSteps)
    model = test_model(args, lambda: WordRNN(
        vocab, args.hiddenSize, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))

    if args.numOfWords:
        device = next(model.parameters()).device
        cur = x[:bs].astype(np.float32)
        with torch.inference_mode():
            for _ in range(args.numOfWords):
                out = model(torch.from_numpy(cur).to(device)).cpu().numpy()
                nxt = out[:, -1].argmax(-1).astype(np.float32) + 1.0
                cur = np.concatenate([cur, nxt[:, None]], axis=1)
        for row in cur[:4]:
            print(" ".join(str(int(t)) for t in row))
        return cur

    ds = arrays_to_dataset(x, y, bs)
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())
    results = Evaluator(model).test(ds, [Loss(crit)], batch_size=bs)
    for name, r in results.items():
        print(f"{name}: {r}")
    loss = results["Loss"].result()[0]
    print(f"perplexity: {np.exp(loss):.2f}")
    return results


if __name__ == "__main__":
    main()

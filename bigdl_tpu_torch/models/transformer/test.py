"""TransformerLM evaluation: per-token perplexity over a held-out corpus
(counterpart of ``bigdl_tpu.models.transformer.test``)::

    python -m bigdl_tpu_torch.models.transformer.test -f dir --model snap
    python -m bigdl_tpu_torch.models.transformer.test --synthetic 5000 \\
        --device cpu

The corpus is ``-f``'s ``test.txt`` (``-f`` may name the file itself)
indexed by ``--dictionary`` or the ``dictionary.json`` beside it (the
train main writes one into ``--checkpoint``), else by a Dictionary built
from the file itself; or ``--synthetic N`` seeded tokens
(``RandomState(1)``). The model is ``--model`` (a module either
package's ``save_module`` wrote) or a fresh one of the given width. The
evaluation runs in evaluation mode under ``torch.inference_mode``, in
contiguous ``[batch, seqLen]`` windows, dropping the ragged tail: the
float32 log-softmax at each target (targets clamped into the
vocabulary, as the JAX CLI's ``mode="clip"`` gather), and prints
``tokens: N avg nll: X perplexity: Y`` as the JAX CLI does.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["main", "nll_sum"]


def nll_sum(model, tokens, targets):
    """The summed negative log-likelihood of ``targets`` (``[B, S]``
    0-based ids, clamped into the vocabulary) under ``model``'s logits
    for ``tokens``, in float32: a 0-d tensor."""
    import torch

    logp = torch.log_softmax(model(tokens).float(), dim=-1)
    idx = targets.long().clamp(0, logp.shape[-1] - 1)
    return -logp.gather(-1, idx[..., None])[..., 0].sum()


def main(argv=None):
    from bigdl_tpu_torch.models._cli import base_parser

    ap = base_parser("Evaluate the Transformer language model")
    ap.add_argument("--vocabSize", type=int, default=4000)
    ap.add_argument("--hiddenSize", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seqLen", type=int, default=128)
    ap.add_argument("--dictionary", default=None,
                    help="dictionary.json saved by the train main")
    args = ap.parse_args(argv)

    import torch

    from bigdl_tpu_torch.dataset import (Dictionary, load_ptb, ptb_arrays,
                                         read_words)
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.models.transformer.train import _WEIGHT_SEED

    if args.synthetic:
        rng = np.random.RandomState(1)
        stream = rng.randint(1, args.vocabSize + 1,
                             args.synthetic).astype(np.float32)
        vocab = args.vocabSize
    else:
        test_txt = args.folder if os.path.isfile(args.folder) else \
            os.path.join(args.folder, "test.txt")
        if not os.path.exists(test_txt):
            raise SystemExit(f"no corpus at '{test_txt}'. Stage a test.txt "
                             f"there, or use --synthetic N.")
        dict_path = args.dictionary or os.path.join(
            os.path.dirname(test_txt), "dictionary.json")
        if os.path.exists(dict_path):
            d = Dictionary.load(dict_path)
            stream = np.asarray(
                [d.get_index(w) for w in read_words(test_txt)], np.float32)
            vocab = d.vocab_size()
        else:
            splits, d = load_ptb(test_txt, vocab_size=args.vocabSize)
            stream, vocab = splits["train"], d.vocab_size()

    if args.model:
        from bigdl_tpu_torch.utils.serialization import load_module
        model = load_module(args.model, device=args.device)
    else:
        model = TransformerLM(
            vocab, hidden_size=args.hiddenSize, num_layers=args.layers,
            num_heads=args.heads, max_len=args.seqLen, device=args.device,
            generator=torch.Generator().manual_seed(_WEIGHT_SEED))
    model.evaluate()
    device = next(model.parameters()).device

    bs = args.batchSize or 8
    x, y = ptb_arrays(stream, bs, args.seqLen)
    x = torch.from_numpy((x - 1).astype(np.int32)).to(device)
    y = torch.from_numpy((y - 1).astype(np.int32)).to(device)
    total, count = 0.0, 0
    with torch.inference_mode():
        for i in range(0, len(x), bs):
            xb, yb = x[i:i + bs], y[i:i + bs]
            if len(xb) < bs:
                break  # the JAX CLI's static shapes: drop the ragged tail
            total += float(nll_sum(model, xb, yb))
            count += xb.numel()
    ppl = np.exp(total / max(count, 1))
    print(f"tokens: {count} avg nll: {total / max(count, 1):.4f} "
          f"perplexity: {ppl:.2f}")
    return ppl


if __name__ == "__main__":
    main()

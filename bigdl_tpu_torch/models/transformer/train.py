"""TransformerLM training recipe on one card (counterpart of
``bigdl_tpu.models.transformer.train``)::

    python -m bigdl_tpu_torch.models.transformer.train --synthetic 20000
    python -m bigdl_tpu_torch.models.transformer.train -f ptb/ \\
        --checkpoint ck/ --inputMode packed --moeExperts 4 --dropout 0.1
    python -m bigdl_tpu_torch.models.transformer.train --synthetic 20000 \\
        --inputMode packed --device cpu --maxIterations 3

The corpus is ``-f dir``'s ``train.txt`` read through the PTB reader and
its Dictionary (written to ``--checkpoint``'s ``dictionary.json``, which
the test main reads), or the JAX CLI's seeded ``--synthetic N`` token
stream: contiguous ``ptb_arrays`` windows (``--inputMode contiguous``),
or documents cut at ``<eos>`` (seeded pseudo-<eos> boundaries in the
synthetic stream) and packed into ``[rows, seqLen]`` slabs with segment
masks (``packed``) or padded one per row by
``LengthBucketBatcher([seqLen], documents)`` (``padded``). Training is
``LocalOptimizer`` with plain SGD (``-r``, default 0.1; ``-d`` decay) on
``SequenceCrossEntropyCriterion``, with the MoE load-balance term in
the objective (``--moeExperts``) and attention dropout (``--dropout``);
``--model``, ``--state`` and ``--checkpoint`` work as in the other
recipes. The script prints ``final loss`` as the JAX CLI does (and,
after a resume, the checkpoint it resumed from); like the JAX CLI it
sets no validation and no summaries.

Not ported yet: pipeline (``--pp``), tensor (``--tp``) and sequence
(``--sp``) parallelism, which raise NotImplementedError (ROADMAP queue
1, item 11). A missing corpus is downloaded into ``-f`` as the JAX CLI
does; when that fails the CLI exits and names ``--synthetic``.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["main", "synthetic_corpus", "text_corpus"]

#: seed of the weights' generator: fixed, as the JAX recipe's init key is
_WEIGHT_SEED = 1


def _split_documents(stream, eos_index):
    """1-based token stream -> list of 0-based int32 documents split at
    ``eos_index`` (each document keeps its trailing <eos>)."""
    s = np.asarray(stream).astype(np.int64)
    docs, lo = [], 0
    for e in np.flatnonzero(s == eos_index):
        doc = s[lo:e + 1]
        if len(doc) >= 2:
            docs.append((doc - 1).astype(np.int32))
        lo = e + 1
    tail = s[lo:]
    if len(tail) >= 2:
        docs.append((tail - 1).astype(np.int32))
    return docs


def _packed_corpus(input_mode, seq_len, stream, eos_index):
    """Documents packed into ``[rows, seq_len]`` slabs with segment masks
    (``packed``) or padded one per row (``padded``): returns
    ``([tokens, segment_ids, positions], targets)``."""
    from bigdl_tpu_torch import datapipe as dp

    docs = _split_documents(stream, eos_index)
    if not docs:
        raise SystemExit("corpus has no documents after <eos> splitting")
    lengths = [min(len(d) - 1, seq_len) for d in docs]
    eff_padded = dp.padding_efficiency(lengths, seq_len)
    if input_mode == "padded":
        batcher = dp.LengthBucketBatcher([seq_len], len(docs))
        (mb,) = list(batcher(iter(docs), 0))
        (toks, segs, pos), tgt = mb.input, mb.target
        eff = batcher.efficiency
    else:
        toks, segs, pos, tgt = dp.pack_documents(docs, seq_len)
        eff = float((segs > 0).mean())
    print(f"input mode {input_mode}: padding_efficiency {eff:.3f} "
          f"(pad-to-max would be {eff_padded:.3f}) over {len(docs)} "
          f"documents, {len(toks)} rows of {seq_len}")
    return [toks, segs, pos], tgt


def _layout(stream, eos_index, seq_len, input_mode, batch_size):
    """A 1-based token stream in the chosen ``input_mode``: ``(x, y)``
    0-based int32 windows, or the packed planes and targets."""
    from bigdl_tpu_torch.dataset import ptb_arrays

    if input_mode != "contiguous":
        return _packed_corpus(input_mode, seq_len, stream, eos_index)
    x, y = ptb_arrays(stream, batch_size, seq_len)
    # ptb_arrays is 1-based; the LM criterion wants 0-based ids
    return (x - 1).astype(np.int32), (y - 1).astype(np.int32)


def synthetic_corpus(n_tokens: int, vocab_size: int, seq_len: int,
                     input_mode: str = "contiguous", batch_size: int = 8):
    """The JAX CLI's ``--synthetic`` corpus, array for array: ``(x, y)``
    int32 0-based windows ``[N, seq_len]`` for ``contiguous``, or
    ``([tokens, segment_ids, positions], targets)`` for ``packed`` /
    ``padded`` (targets -1 at pad and boundary positions)."""
    rng = np.random.RandomState(0)
    stream = rng.randint(1, vocab_size + 1, n_tokens).astype(np.float32)
    eos = None
    if input_mode != "contiguous":
        # ragged synthetic documents: seeded pseudo-<eos> boundaries
        eos = vocab_size
        cuts = rng.randint(8, max(9, seq_len // 2),
                           max(1, n_tokens // 16))
        pos = np.minimum(np.cumsum(cuts), n_tokens - 1)
        stream[pos] = eos
    return _layout(stream, eos, seq_len, input_mode, batch_size)


def text_corpus(args):
    """``-f``'s ``train.txt`` (``-f`` may name the file itself) in the
    chosen layout, and the Dictionary's vocabulary size; with
    ``--checkpoint`` the Dictionary is saved there as
    ``dictionary.json``."""
    from bigdl_tpu_torch.dataset import load_ptb

    train_txt = args.folder if os.path.isfile(args.folder) else \
        os.path.join(args.folder, "train.txt")
    if not os.path.exists(train_txt):
        # download-if-missing, as the JAX CLI does
        from bigdl_tpu_torch.dataset import fetch
        try:
            train_txt = fetch.get_text_corpus(args.folder)
        except Exception as e:
            raise SystemExit(
                f"no corpus at '{train_txt}' and auto-download failed "
                f"({type(e).__name__}: {e}). Pre-stage a train.txt there, "
                "or use --synthetic N.")
    splits, d = load_ptb(train_txt, vocab_size=args.vocabSize)
    if args.checkpoint:
        os.makedirs(args.checkpoint, exist_ok=True)
        d.save(os.path.join(args.checkpoint, "dictionary.json"))
    return _layout(splits["train"], d.get_index("<eos>"), args.seqLen,
                   args.inputMode, args.batchSize or 8), d.vocab_size()


def main(argv=None):
    from bigdl_tpu_torch.models._cli import (base_parser, load_model_or,
                                             wire_optimizer)

    ap = base_parser("Train the Transformer language model")
    ap.add_argument("--vocabSize", type=int, default=4000)
    ap.add_argument("--hiddenSize", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seqLen", type=int, default=128)
    ap.add_argument("--inputMode",
                    choices=("contiguous", "packed", "padded"),
                    default="contiguous",
                    help="'contiguous' = ptb_arrays stream windows; "
                    "'packed' = documents packed into [B, seqLen] slabs "
                    "with segment masks; 'padded' = one document per "
                    "row padded to seqLen")
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--moeExperts", type=int, default=0)
    # the JAX CLI's parallelism flags raise (item 11)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", choices=("none", "ring", "ulysses"),
                    default="none")
    args = ap.parse_args(argv)

    for flag, value, default in (("--pp", args.pp, 1), ("--tp", args.tp, 1),
                                 ("--sp", args.sp, "none")):
        if value != default:
            raise NotImplementedError(
                f"{flag} {value}: pipeline, tensor and sequence "
                f"parallelism are not ported yet (ROADMAP queue 1, "
                f"item 11)")

    import torch

    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    bs = args.batchSize or 8
    if args.synthetic:
        x, y = synthetic_corpus(args.synthetic, args.vocabSize,
                                args.seqLen, args.inputMode, bs)
        vocab = args.vocabSize
    else:
        (x, y), vocab = text_corpus(args)
    if isinstance(x, list):
        samples = [Sample([plane[i] for plane in x], y[i])
                   for i in range(len(x[0]))]
        criterion = SequenceCrossEntropyCriterion(ignore_index=-1)
    else:
        samples = [Sample(x[i], y[i]) for i in range(len(x))]
        criterion = SequenceCrossEntropyCriterion()
    ds = DataSet.array(samples).transform(SampleToMiniBatch(bs))
    model = load_model_or(args, lambda: TransformerLM(
        vocab, hidden_size=args.hiddenSize, num_layers=args.layers,
        num_heads=args.heads, max_len=args.seqLen, dropout=args.dropout,
        moe_experts=args.moeExperts, device=args.device,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))
    optim = SGD(learning_rate=args.learningRate or 0.1,
                learning_rate_decay=args.learningRateDecay or 0.0)
    opt = LocalOptimizer(model, ds, criterion, batch_size=bs)
    wire_optimizer(opt, args, optim, default_epochs=1)
    opt.optimize()
    loss = opt.driver_state["Loss"]
    print(f"final loss: {loss:.4f} perplexity: {np.exp(loss):.2f}")
    if opt.resumed_from is not None:
        print(f"resumed from {opt.resumed_from['path']} at neval "
              f"{opt.resumed_from['neval']}")
    return model


if __name__ == "__main__":
    main()

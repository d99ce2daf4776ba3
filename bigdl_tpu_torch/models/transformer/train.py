"""TransformerLM training recipe (counterpart of
``bigdl_tpu.models.transformer.train``)::

    python -m bigdl_tpu_torch.models.transformer.train --synthetic 20000
    python -m bigdl_tpu_torch.models.transformer.train -f ptb/ \\
        --checkpoint ck/ --inputMode packed --moeExperts 4 --dropout 0.1
    python -m bigdl_tpu_torch.models.transformer.train --synthetic 20000 \\
        --inputMode packed --device cpu --maxIterations 3
    # two ranks, ring-attention sequence parallelism over them
    python -m bigdl_tpu_torch.tools.launch --nproc 2 \\
        bigdl_tpu_torch/models/transformer/train.py --synthetic 20000 \\
        --sp ring --spSize 2 --seqLen 2048

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

Launched as a gang (``tools.launch``: ``WORLD_SIZE`` and the rest in
the environment) the script starts the process group
(``utils.engine.init_distributed``) and carves the ranks into a mesh
(:func:`build_mesh_for`): a ``seq`` axis of ``--spSize`` ranks when
``--sp ring|ulysses`` is set (``--spSize`` is raised to 2 when smaller,
as in the JAX CLI), and ``data`` over the rest, each data rank feeding
its ``DataSet.sharded`` share of the rows (``-b`` is the global batch).
The model is built with ``ring_axis="seq"`` then. Besides the JAX
CLI's line, a run on a mesh prints ``mesh: ...`` with the backend and
the final loss in full. ``--sp`` with a non-contiguous ``--inputMode``
raises ValueError, as in the JAX CLI; so does a world that the
requested degrees do not divide.

Not ported yet: pipeline (``--pp``) and tensor (``--tp``) parallelism,
which raise NotImplementedError (ROADMAP queue 1, item 11). A missing
corpus is downloaded into ``-f`` as the JAX CLI does; when that fails
the CLI exits and names ``--synthetic``.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["build_mesh_for", "main", "synthetic_corpus", "text_corpus"]

#: seed of the weights' generator: fixed, as the JAX recipe's init key is
_WEIGHT_SEED = 1


def build_mesh_for(pp: int, tp: int, sp_size: int):
    """Carve the ranks into ``(data[, seq])``: data parallelism takes
    whatever ``pp * tp * sp_size`` leaves. Returns ``(mesh, axes)``, the
    mesh None for one rank with no parallelism asked for (the JAX CLI's
    ``build_mesh_for`` over ranks instead of devices)."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import make_mesh

    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    need = pp * tp * sp_size
    if n % need:
        raise ValueError(
            f"device count {n} not divisible by pp*tp*spSize={need}")
    sizes, names = [n // need], ["data"]
    if sp_size > 1:
        sizes.append(sp_size)
        names.append("seq")
    if sizes == [1]:
        return None, names
    return make_mesh(sizes, names), names


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
    # pipeline and tensor parallelism raise (item 11)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", choices=("none", "ring", "ulysses"),
                    default="none", help="sequence parallelism kernel")
    ap.add_argument("--spSize", type=int, default=1,
                    help="sequence-parallel degree (mesh 'seq' axis)")
    args = ap.parse_args(argv)

    for flag, value in (("--pp", args.pp), ("--tp", args.tp)):
        if value != 1:
            raise NotImplementedError(
                f"{flag} {value}: pipeline and tensor parallelism are not "
                f"ported yet (ROADMAP queue 1, item 11)")
    if args.sp != "none" and args.spSize < 2:
        args.spSize = 2
    if args.inputMode != "contiguous" and args.sp != "none":
        raise ValueError(
            "--inputMode packed/padded needs the dense TransformerLM "
            "(segment masks are unsupported on the pipelined and "
            "sequence-parallel paths)")

    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch.utils import engine

    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer

    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        # a launched gang (tools.launch): one process a rank
        if args.device == "cpu":
            torch.set_num_threads(1)
        engine.init_distributed(
            backend=None if args.device != "cpu" else "gloo")
    mesh, _ = build_mesh_for(args.pp, args.tp,
                             args.spSize if args.sp != "none" else 1)
    device = engine.rank_device(args.device) if mesh is not None \
        or dist.is_initialized() else args.device
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
    ndata = mesh.shape["data"] if mesh is not None else 1
    if bs % ndata:
        raise ValueError(f"batch {bs} does not split over the {ndata}-rank "
                         f"data axis")
    if ndata > 1:
        ds = DataSet.sharded(samples, mesh.axis_index("data"), ndata) \
            .transform(SampleToMiniBatch(bs // ndata))
    else:
        ds = DataSet.array(samples).transform(SampleToMiniBatch(bs))
    sp = args.sp != "none"
    model = load_model_or(args, lambda: TransformerLM(
        vocab, hidden_size=args.hiddenSize, num_layers=args.layers,
        num_heads=args.heads, max_len=args.seqLen, dropout=args.dropout,
        moe_experts=args.moeExperts, device=device,
        ring_axis="seq" if sp else None,
        sp_impl=args.sp if sp else "ring", mesh=mesh,
        generator=torch.Generator().manual_seed(_WEIGHT_SEED)))
    # a snapshot carries no mesh (runtime placement): reattach it, so a
    # resumed run keeps its parallelism
    for blk in model.blocks:
        blk.attn.mesh = mesh
        if sp:
            blk.attn.ring_axis, blk.attn.sp_impl = "seq", args.sp
    optim = SGD(learning_rate=args.learningRate or 0.1,
                learning_rate_decay=args.learningRateDecay or 0.0)
    opt = Optimizer(model, ds, criterion, batch_size=bs, mesh=mesh)
    wire_optimizer(opt, args, optim, default_epochs=1)
    opt.optimize()
    loss = opt.driver_state["Loss"]
    print(f"final loss: {loss:.4f} perplexity: {np.exp(loss):.2f}")
    if dist.is_initialized():
        print(f"mesh: {None if mesh is None else mesh.shape} backend: "
              f"{dist.get_backend()} rank: {dist.get_rank()} loss: "
              f"{loss!r}", flush=True)
    if opt.resumed_from is not None:
        print(f"resumed from {opt.resumed_from['path']} at neval "
              f"{opt.resumed_from['neval']}")
    return model


if __name__ == "__main__":
    main()

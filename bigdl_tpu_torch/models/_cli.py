"""Shared flags of the training entry points (counterpart of
``bigdl_tpu.models._cli``): the reference recipes' ``-b``, ``-e``,
``-r``, ``-d``, ``--maxIterations`` and ``--synthetic N``, plus the
port's ``--device``.

Not ported yet: ``-f`` corpora, ``--model`` / ``--state`` snapshots,
``--checkpoint``, ``--quantize`` and ``--steps-per-sync``.
"""
from __future__ import annotations

import argparse

__all__ = ["base_parser", "wire_optimizer"]


def base_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("-b", "--batchSize", type=int, default=None)
    ap.add_argument("-e", "--maxEpoch", type=int, default=None)
    ap.add_argument("-r", "--learningRate", type=float, default=None)
    ap.add_argument("-d", "--learningRateDecay", type=float, default=None)
    ap.add_argument("--maxIterations", type=int, default=None,
                    help="stop after N iterations (overrides maxEpoch)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train on a seeded synthetic stream of N tokens")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def wire_optimizer(opt, args, optim_method, default_epochs: int = 1):
    """set_optim_method / set_end_when in the reference shape."""
    from bigdl_tpu_torch.optim import max_epoch, max_iteration

    opt.set_optim_method(optim_method)
    if args.maxIterations:
        opt.set_end_when(max_iteration(args.maxIterations))
    else:
        opt.set_end_when(max_epoch(args.maxEpoch or default_epochs))
    return opt

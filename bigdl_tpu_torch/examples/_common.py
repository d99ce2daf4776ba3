"""Shared pieces of the example mains."""
from __future__ import annotations

import argparse

import torch

from bigdl_tpu_torch.utils.random import RandomGenerator

__all__ = ["add_device_flag", "example_device", "seeded_generator"]


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")


def example_device(name: str) -> torch.device:
    """``--device`` as a torch device; a SystemExit naming the flag when
    the card is asked for and none is visible."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run "
                         "this example on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: cuda or cpu")
    return dev


def seeded_generator() -> torch.Generator:
    """The CPU generator the example's weights are drawn from, seeded
    from the process-wide seed (``RandomGenerator.set_seed``)."""
    return torch.Generator().manual_seed(RandomGenerator.get_seed())

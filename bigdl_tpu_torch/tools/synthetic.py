"""Seeded synthetic data (counterpart of ``bigdl_tpu.tools.synthetic``:
the image generator the recipes' ``--synthetic N`` flag reads).

All randomness is ``np.random.RandomState(seed)``, drawn in the JAX
package's order, so the rows are bitwise the JAX package's. ``seed=0``
is the training draw, ``seed=1`` the evaluation draw.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["SEED_EVAL", "SEED_TRAIN", "image_batch", "seeded_rng",
           "token_batch"]

SEED_TRAIN = 0
SEED_EVAL = 1


def seeded_rng(seed: int) -> np.random.RandomState:
    """The RNG constructor of every synthetic data path."""
    return np.random.RandomState(seed)


def image_batch(n: int, shape: Tuple[int, ...], classes: int,
                seed: int = SEED_TRAIN) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform float32 images ``[n, *shape]`` and 1-based float32
    labels."""
    rng = seeded_rng(seed)
    x = rng.rand(n, *shape).astype(np.float32)
    y = rng.randint(1, classes + 1, n).astype(np.float32)
    return x, y


def token_batch(n: int, seq_len: int, vocab: int, seed: int = SEED_TRAIN,
                one_based: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Random token windows ``[n, seq_len]`` and next-token targets of
    the same shape (the language-model perf feed)."""
    rng = seeded_rng(seed)
    lo = 1 if one_based else 0
    x = rng.randint(lo, vocab + lo, (n, seq_len))
    y = rng.randint(lo, vocab + lo, (n, seq_len))
    return x, y

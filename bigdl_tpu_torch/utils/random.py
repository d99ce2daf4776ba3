"""Deterministic host RNG (counterpart of ``bigdl_tpu.utils.random``).

A process-global seed and a numpy MT19937 stream for host-side sampling
(dataset shuffles): the JAX package's ``RandomGenerator`` without its
``jax.random`` key derivation. One seed gives the same shuffle order in
both packages, record for record. Parameter init in the port takes an
explicit ``torch.Generator`` instead of a global key.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["RandomGenerator"]


class RandomGenerator:
    """Process-global seed registry + numpy MT19937 for host-side
    sampling."""

    _lock = threading.Lock()
    _seed = 1
    _numpy = np.random.RandomState(1)

    @classmethod
    def set_seed(cls, seed: int):
        with cls._lock:
            cls._seed = int(seed)
            cls._numpy = np.random.RandomState(cls._seed & 0x7FFFFFFF)
        return cls

    @classmethod
    def numpy(cls) -> np.random.RandomState:
        """Host-side RNG (shuffles, data augmentation)."""
        return cls._numpy

"""Window stacking (the host part of ``bigdl_tpu.dataset.prefetch``).

``stack_windows`` groups ``k`` consecutive equal-shaped MiniBatches into
one ``[k, ...]`` stacked MiniBatch: the buffer layout one window of
``k`` train steps reads (``Optimizer.set_steps_per_sync``, whose
CUDA-graph window copies it into its static inputs). The windowed
Optimizer groups inline — it must also flush windows at trigger
boundaries — with the same unit, ``stack_minibatches`` /
``batch_signature``.

Not ported yet: ``device_prefetch`` (the staged double buffer) and the
device-fed and rotating windows (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["batch_signature", "stack_minibatches", "stack_windows"]


def _array(x):
    """A host leaf as numpy (a CPU tensor through ``.numpy()``)."""
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


def _stack_leaves(parts):
    """Stack matching MiniBatch leaves along a new leading axis, keeping
    list/tuple input structure; None targets stay None."""
    def stk(*leaves):
        if any(v is None for v in leaves):
            if not all(v is None for v in leaves):
                raise ValueError(
                    "cannot window-stack batches that mix None and "
                    "non-None targets")
            return None
        if isinstance(leaves[0], (list, tuple)):
            return type(leaves[0])(
                stk(*grp) for grp in zip(*leaves))
        return np.stack([_array(v) for v in leaves])
    return stk(*parts)


def stack_windows(it: Iterator[MiniBatch], k: int) -> Iterator[MiniBatch]:
    """Group ``k`` consecutive MiniBatches into one stacked MiniBatch
    whose every leaf gains a leading window axis of length ``k``.

    All ``k`` members of a window must agree in shape; a shape change
    (a short final batch) closes the current window early, and the tail
    comes out as a shorter window. Each distinct window length captures
    its own graph downstream."""
    if k < 1:
        raise ValueError(f"window size must be >= 1, got {k}")
    pend: List[MiniBatch] = []
    sig = None

    def flush():
        nonlocal sig
        if not pend:
            return None
        out = stack_minibatches(pend)
        pend.clear()
        sig = None
        return out

    for b in it:
        s = batch_signature(b)
        # the flush after an append keeps pend below k here; only a shape
        # change closes a window early
        if pend and s != sig:
            yield flush()
        if not pend:
            sig = s
        pend.append(b)
        if len(pend) >= k:
            yield flush()
    tail = flush()
    if tail is not None:
        yield tail


def stack_minibatches(batches) -> MiniBatch:
    """Stack equal-shaped MiniBatches into one windowed MiniBatch with a
    leading axis of length ``len(batches)``."""
    return MiniBatch(_stack_leaves([b.input for b in batches]),
                     _stack_leaves([b.target for b in batches]))


def batch_signature(batch: MiniBatch):
    """Nested ``(shape, dtype)`` signature: two batches stack iff equal.
    Dtypes are numpy's names, as the JAX package records them (torch's
    names without the prefix are numpy's; a tensor on the card is read
    where it lies)."""
    def leaf(x):
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return tuple(leaf(e) for e in x)
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype).removeprefix("torch."))
        a = _array(x)
        return (a.shape, str(a.dtype))
    return (leaf(batch.input), leaf(batch.target))

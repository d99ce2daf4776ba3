"""Samples and mini-batches (counterpart of
``bigdl_tpu.dataset.sample``).

A :class:`Sample` holds one record's features and labels as numpy
arrays, each one array or a list of arrays (multi-plane inputs such as
the packed ``[tokens, segment_ids, positions]``);
:func:`samples_to_minibatch` stacks records into a :class:`MiniBatch`.
Batches stay numpy on the host: the optimizer moves them to the model's
device.

Not ported yet: sparse features, padding of variable-size records.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["MiniBatch", "Sample", "samples_to_minibatch"]


class Sample:
    """A feature/label pair; features and labels may each be one array
    or a list of arrays (``ArraySample`` in the reference)."""

    def __init__(self, feature, label=None):
        self.features = [np.asarray(f) for f in
                         (feature if isinstance(feature, (list, tuple))
                          else [feature])]
        if label is None:
            self.labels = []
        else:
            self.labels = [np.asarray(l) for l in
                           (label if isinstance(label, (list, tuple))
                            else [label])]

    def __repr__(self):
        fs = ",".join(str(f.shape) for f in self.features)
        ls = ",".join(str(l.shape) for l in self.labels)
        return f"Sample(features=[{fs}], labels=[{ls}])"


class MiniBatch:
    """A stacked batch: ``input``/``target`` are numpy arrays, or lists
    of arrays for multi-plane inputs."""

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def size(self) -> int:
        x = self.input[0] if isinstance(self.input, (list, tuple)) \
            else self.input
        return x.shape[0]

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target


def _stack(arrays: List[np.ndarray]) -> np.ndarray:
    shapes = {a.shape for a in arrays}
    if len(shapes) != 1:
        raise ValueError(f"records of one batch must share a shape, got "
                         f"{sorted(shapes)} (padding is not ported yet)")
    return np.stack(arrays)


def samples_to_minibatch(samples: Sequence[Sample]) -> MiniBatch:
    """Stack samples into one MiniBatch: one array per feature plane
    (a list when there are several) and likewise for labels."""
    n_feat = len(samples[0].features)
    n_lab = len(samples[0].labels)
    feats = [_stack([s.features[i] for s in samples]) for i in range(n_feat)]
    labs = [_stack([s.labels[i] for s in samples]) for i in range(n_lab)]
    input = feats[0] if n_feat == 1 else feats
    target = None if n_lab == 0 else (labs[0] if n_lab == 1 else labs)
    return MiniBatch(input, target)

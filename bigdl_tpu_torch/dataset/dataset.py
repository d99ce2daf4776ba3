"""DataSet abstractions (counterpart of ``bigdl_tpu.dataset.dataset``).

:class:`LocalDataSet` keeps the reference's iterator contract:
``data(train=True)`` loops over the elements forever in the current
permutation, ``data(train=False)`` is one pass in order, ``shuffle()``
permutes with :class:`~bigdl_tpu_torch.utils.random.RandomGenerator`'s
numpy stream (so one seed gives the JAX package's order record for
record), ``size()`` counts elements. :class:`ShardedDataSet` gives
process ``i`` of ``n`` the elements ``i::n``; :class:`PipelineDataSet`
is a streaming :class:`~bigdl_tpu_torch.datapipe.Pipeline` as a
DataSet; ``DataSet.image_folder`` and ``DataSet.record_shards`` build
the threaded ImageNet feed
(:class:`~bigdl_tpu_torch.dataset.imagenet.ImageFolderDataSet`).

Not ported yet: the device-cached and rotating datasets.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.random import RandomGenerator

__all__ = ["AbstractDataSet", "DataSet", "LocalDataSet", "PipelineDataSet",
           "ShardedDataSet", "TransformedDataSet", "array_to_samples"]


class AbstractDataSet:
    """DataSet contract: ``data(train)`` yields elements;
    ``size``/``shuffle``/``transform`` as in the reference."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        return self

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    # the reference's `dataset -> transformer`
    def __rshift__(self, transformer: Transformer):
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """In-memory dataset over a list of elements."""

    def __init__(self, elements: Sequence):
        self.elements = list(elements)
        self._perm = np.arange(len(self.elements))

    def size(self) -> int:
        return len(self.elements)

    def shuffle(self):
        RandomGenerator.numpy().shuffle(self._perm)
        return self

    def data(self, train: bool) -> Iterator:
        if train:
            while True:
                for i in self._perm:
                    yield self.elements[i]
        else:
            for i in range(len(self.elements)):
                yield self.elements[i]


class TransformedDataSet(AbstractDataSet):
    """A dataset viewed through a Transformer chain; ``size`` and
    ``shuffle`` act on the base (records, not batches)."""

    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    @property
    def continuous_stream(self) -> bool:
        """The base's stream semantics, so the optimizer's epoch
        rollover keeps its carry through ``.transform()``."""
        return getattr(self.base, "continuous_stream", False)

    def size(self) -> int:
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def data(self, train: bool) -> Iterator:
        return self.transformer.apply(self.base.data(train))


class ShardedDataSet(AbstractDataSet):
    """Multi-host sharding (DataSet.scala:164,240's distributed sets):
    process ``process_index`` of ``process_count`` sees the elements
    ``i`` with ``i % count == index``; on one host it is a
    LocalDataSet."""

    def __init__(self, elements: Sequence, process_index: int = 0,
                 process_count: int = 1):
        self.all_elements = list(elements)
        self.process_index = process_index
        self.process_count = process_count
        shard = self.all_elements[process_index::process_count]
        self.local = LocalDataSet(shard)

    def size(self) -> int:
        return len(self.all_elements)

    def local_size(self) -> int:
        return self.local.size()

    def shuffle(self):
        self.local.shuffle()
        return self

    def data(self, train: bool) -> Iterator:
        return self.local.data(train)


def array_to_samples(features: np.ndarray,
                     labels: Optional[np.ndarray] = None) -> List[Sample]:
    """Rows of ``(features, labels)`` arrays -> Samples."""
    return [Sample(features[i], None if labels is None else labels[i])
            for i in range(len(features))]


class PipelineDataSet(AbstractDataSet):
    """A streaming :class:`~bigdl_tpu_torch.datapipe.Pipeline` as a
    DataSet: ``data(train=True)`` is the pipeline's looped stream (its
    per-epoch reseeded shuffle and packing happen inside, so
    ``shuffle()`` does nothing), ``data(train=False)`` a repeatable
    pass that leaves the cursor alone; ``size()`` is records per epoch
    in emitted units (MiniBatch rows when the pipeline batches or
    packs).

    ``continuous_stream = True``: the optimizer's epoch rollover keeps
    its overshoot carry and never restarts the iterator, since the
    pipeline owns its epoch boundaries. The optimizer checkpoints
    :meth:`pipeline_state` into ``driver_state["datapipe"]`` and
    restores it on resume (one process).

    With ``staged_k``, training batches come as ``[K, B, ...]`` windows
    already on ``device`` (``Pipeline.staged(k=staged_k)``): the
    windowed optimizer copies a window into its CUDA graph's inputs
    device to device, the per-step loop runs its rows one by one.

    The driver divides consumed rows by this fixed ``size``; a stage
    whose output count varies with record order (packing after a
    per-epoch reshuffle) makes that a rate, so the driver's epoch can
    drift from the reader's by a few rows an epoch (docs/data.md)."""

    continuous_stream = True

    def __init__(self, pipeline, size: int, batch_size: Optional[int] = None,
                 staged_k: Optional[int] = None, device="cuda"):
        self.pipeline = pipeline
        self._size = int(size)
        if batch_size is not None:
            # emitted rows per MiniBatch, for the windowed driver's plan
            self.batch_size = int(batch_size)
        self.staged_k = staged_k
        self.device = device

    def size(self) -> int:
        return self._size

    def shuffle(self):
        return self

    def data(self, train: bool) -> Iterator:
        if not train:
            return self.pipeline.iterate_detached()
        if self.staged_k is not None:
            return self.pipeline.staged(k=self.staged_k, loop=True,
                                        device=self.device)
        return self.pipeline.iterate(loop=True)

    def pipeline_state(self) -> dict:
        """The source cursor, for the checkpoint's driver_state."""
        return self.pipeline.state()

    def restore_pipeline_state(self, state: dict) -> None:
        """Resume the source cursor from a checkpointed snapshot."""
        self.pipeline.restore(state)


class DataSet:
    """Factory namespace (``object DataSet`` in the reference)."""

    @staticmethod
    def array(elements, labels=None) -> LocalDataSet:
        if labels is not None:
            return LocalDataSet(array_to_samples(np.asarray(elements),
                                                 np.asarray(labels)))
        return LocalDataSet(list(elements))

    @staticmethod
    def sharded(elements, process_index: int = 0,
                process_count: int = 1) -> ShardedDataSet:
        return ShardedDataSet(elements, process_index, process_count)

    @staticmethod
    def image_folder(path: str, **kw):
        """``DataSet.ImageFolder`` (DataSet.scala:408): threaded decode
        and augmentation over a ``<class>/<img>`` tree."""
        from bigdl_tpu_torch.dataset.imagenet import ImageFolderDataSet
        return ImageFolderDataSet(path, **kw)

    @staticmethod
    def record_shards(shards, **kw):
        """``DataSet.SeqFileFolder``'s counterpart (DataSet.scala:470-552)
        over image record shard files."""
        from bigdl_tpu_torch.dataset.imagenet import ImageFolderDataSet
        return ImageFolderDataSet(record_shards=list(shards), **kw)

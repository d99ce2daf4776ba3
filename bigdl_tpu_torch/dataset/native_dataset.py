"""A dataset over the native C++ batch loader (counterpart of
``bigdl_tpu.dataset.native_dataset``; the reference's multi-threaded
MTLabeledBGRImgToBatch batch builder).

:class:`NativeArrayDataSet` yields MiniBatches that C++ worker threads
made (random pad-crop, flip, normalize), so host preprocessing
overlaps the card's steps. Callers check :func:`native_available`
first: the constructor raises when the native library cannot build,
and the numpy DataSet/Transformer pipeline is the other path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["NativeArrayDataSet", "native_available"]


def native_available() -> bool:
    """True when the C++ loader (``native/src/dataloader.cpp``) is built
    and loads, building it if needed."""
    from bigdl_tpu_torch import native
    return native.native_available()


class NativeArrayDataSet(AbstractDataSet):
    """In-memory ``[N, C, H, W]`` images and labels with native
    augmentation. Training batches come from one threaded loader that
    draws rows at random; an evaluation pass runs a fresh one-thread
    loader over the rows in order, centre-cropped, its last batch
    trimmed so no sample counts twice."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, crop: Optional[tuple] = None,
                 pad: int = 0, flip: bool = True, mean=None, std=None,
                 num_threads: int = 4, prefetch: int = 4, seed: int = 0):
        from bigdl_tpu_torch import native
        self.images = np.ascontiguousarray(images, np.float32)
        self.labels = np.ascontiguousarray(labels, np.float32)
        self.batch_size = batch_size
        self._kw = dict(crop=crop, pad=pad, flip=flip, mean=mean, std=std,
                        num_threads=num_threads, prefetch=prefetch,
                        seed=seed)
        self._train_loader = native.NativeBatchLoader(
            self.images, self.labels, batch_size, train=True, **self._kw)
        self._native = native

    def size(self) -> int:
        return len(self.images)

    def shuffle(self) -> None:
        pass  # the training loader draws rows at random already

    def data(self, train: bool = True):
        if train:
            def it():
                while True:
                    imgs, lbls = self._train_loader.next_batch()
                    yield MiniBatch(imgs, lbls)
            return it()
        kw = dict(self._kw)
        kw.update(flip=False, num_threads=1, prefetch=1)

        def eval_it():
            n = len(self.images)
            loader = self._native.NativeBatchLoader(
                self.images, self.labels, self.batch_size, train=False,
                **kw)
            try:
                remaining = n
                while remaining > 0:
                    imgs, lbls = loader.next_batch()
                    if remaining < self.batch_size:
                        imgs, lbls = imgs[:remaining], lbls[:remaining]
                    remaining -= len(lbls)
                    yield MiniBatch(imgs, lbls)
            finally:
                loader.close()
        return eval_it()

    def close(self) -> None:
        self._train_loader.close()

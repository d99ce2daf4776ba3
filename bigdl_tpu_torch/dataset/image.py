"""Image dataset readers (counterpart of ``bigdl_tpu.dataset.image``:
the MNIST and CIFAR-10 binary readers, in numpy).

Not ported yet: the native idx and CIFAR parsers (queue item 10), the
image transformers and ImageNet.
"""
from __future__ import annotations

import gzip
import struct
from typing import Sequence

import numpy as np

__all__ = ["load_cifar10", "load_mnist", "parse_idx"]


def parse_idx(buf: bytes) -> np.ndarray:
    """An idx file's unsigned-byte tensor as float32 in its own dims."""
    if len(buf) < 4 or buf[0] or buf[1] or buf[2] != 0x08:
        raise ValueError("not an unsigned-byte idx file")
    ndim = buf[3]
    dims = struct.unpack(f">{ndim}I", buf[4:4 + 4 * ndim])
    return np.frombuffer(buf, np.uint8, count=int(np.prod(dims)),
                         offset=4 + 4 * ndim).reshape(dims) \
        .astype(np.float32)


def _read(path: str) -> bytes:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return f.read()


def load_mnist(images_path: str, labels_path: str):
    """MNIST idx files (plain or ``.gz``) -> ``(images [N, 1, 28, 28]
    float32 in 0-255, labels [N] 1-based float32)``."""
    imgs = parse_idx(_read(images_path))
    lbls = parse_idx(_read(labels_path))
    return imgs.reshape(-1, 1, 28, 28).astype(np.float32), \
        lbls.astype(np.float32) + 1.0


def load_cifar10(bin_paths: Sequence[str]):
    """CIFAR-10 binary batches (records of a label byte and 3 x 32 x 32
    pixel bytes) -> ``(images [N, 3, 32, 32] float32 in 0-255, labels
    [N] 1-based float32)``; a partial record at a file's end is
    dropped."""
    rec = 1 + 3 * 32 * 32
    imgs_all, lbls_all = [], []
    for p in bin_paths:
        with open(p, "rb") as f:
            data = f.read()
        n = len(data) // rec
        arr = np.frombuffer(data, np.uint8, count=n * rec).reshape(n, rec)
        lbls_all.append(arr[:, 0].astype(np.float32) + 1.0)
        imgs_all.append(arr[:, 1:].reshape(n, 3, 32, 32).astype(np.float32))
    return np.concatenate(imgs_all), np.concatenate(lbls_all)

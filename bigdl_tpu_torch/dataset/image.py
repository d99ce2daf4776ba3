"""Image transformers and dataset readers (counterpart of
``bigdl_tpu.dataset.image``; the reference's dataset/image/ —
BytesToBGRImg, BGRImgCropper, BGRImgNormalizer, HFlip, ColorJitter,
Lighting — and the MNIST and CIFAR-10 binary readers, in numpy).

Transformers work on Samples whose feature is a CHW float32 array and
draw from their own ``np.random.RandomState``; the arithmetic is the
JAX package's, in its order of operations, so one seed gives bitwise
equal float32 output. :func:`color_jitter_chw` and :func:`lighting_chw`
are shared with the threaded ImageNet augmenter
(:mod:`bigdl_tpu_torch.dataset.imagenet`).

:func:`load_mnist` parses with the native idx parser
(:mod:`bigdl_tpu_torch.native`) where the native library builds, as the
JAX package does, and with :func:`parse_idx` in numpy where it does not:
the same arrays either way.
"""
from __future__ import annotations

import gzip
import struct
from typing import Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["BytesToImg", "ColorJitter", "HFlip", "ImgCropper",
           "ImgNormalizer", "LIGHTING_EIGVAL", "LIGHTING_EIGVEC", "Lighting",
           "color_jitter_chw", "idx_parser", "lighting_chw", "load_cifar10",
           "load_mnist", "parse_idx"]


def _label(s: Sample):
    return s.labels[0] if s.labels else None


class BytesToImg(Transformer):
    """``(HWC uint8 bytes, label)`` records -> CHW float32 Samples
    (BytesToBGRImg)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.height, self.width, self.channels = height, width, channels

    def apply(self, it):
        for data, label in it:
            arr = np.frombuffer(data, np.uint8).reshape(
                self.height, self.width, self.channels)
            yield Sample(arr.transpose(2, 0, 1).astype(np.float32), label)


class ImgNormalizer(Transformer):
    """Per-channel ``(x - mean) / std`` (BGRImgNormalizer)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def apply(self, it):
        for s in it:
            yield Sample((np.asarray(s.features[0], np.float32) - self.mean)
                         / self.std, _label(s))


class ImgCropper(Transformer):
    """Random (train) or center crop to ``(crop_h, crop_w)``
    (BGRImgCropper), after an optional zero padding (the CIFAR
    recipe)."""

    def __init__(self, crop_h: int, crop_w: int, pad: int = 0,
                 random: bool = True, seed: int = 0):
        self.crop_h, self.crop_w = crop_h, crop_w
        self.pad = pad
        self.random = random
        self.rng = np.random.RandomState(seed)

    def apply(self, it):
        for s in it:
            img = np.asarray(s.features[0], np.float32)
            c, h, w = img.shape
            if self.pad:
                padded = np.zeros((c, h + 2 * self.pad, w + 2 * self.pad),
                                  np.float32)
                padded[:, self.pad:self.pad + h, self.pad:self.pad + w] = img
                img = padded
                h, w = img.shape[1:]
            if self.random:
                oy = self.rng.randint(0, h - self.crop_h + 1)
                ox = self.rng.randint(0, w - self.crop_w + 1)
            else:
                oy = (h - self.crop_h) // 2
                ox = (w - self.crop_w) // 2
            yield Sample(img[:, oy:oy + self.crop_h, ox:ox + self.crop_w],
                         _label(s))


class HFlip(Transformer):
    """Random horizontal flip with probability ``threshold`` (HFlip)."""

    def __init__(self, threshold: float = 0.5, seed: int = 0):
        self.threshold = threshold
        self.rng = np.random.RandomState(seed)

    def apply(self, it):
        for s in it:
            img = np.asarray(s.features[0])
            if self.rng.rand() < self.threshold:
                img = img[:, :, ::-1].copy()
            yield Sample(img, _label(s))


_LUMA = np.array([0.299, 0.587, 0.114], np.float32).reshape(3, 1, 1)

#: ImageNet's RGB PCA statistics on 0-1 pixels (Lighting.scala)
LIGHTING_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
LIGHTING_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]], np.float32)


def color_jitter_chw(img: np.ndarray, rng, brightness: float = 0.4,
                     contrast: float = 0.4, saturation: float = 0.4
                     ) -> np.ndarray:
    """Brightness, contrast and saturation in a random order, each a
    blend toward black, the mean gray or the per-pixel luma
    (ColorJitter.scala:52-83, its 0.299/0.587/0.114 weights)."""
    mags = (brightness, contrast, saturation)
    for kind in rng.permutation(3):
        mag = mags[kind]
        if mag <= 0:
            continue
        alpha = 1.0 + rng.uniform(-mag, mag)
        if kind == 0:    # brightness: blend with black
            img = img * alpha
        elif kind == 1:  # contrast: blend with the mean gray
            gray = (img * _LUMA).sum(0).mean()
            img = img * alpha + gray * (1 - alpha)
        else:            # saturation: blend with the per-pixel gray
            gs = (img * _LUMA).sum(0, keepdims=True)
            img = img * alpha + gs * (1 - alpha)
    return img


def lighting_chw(img: np.ndarray, rng, alpha_std: float = 0.1,
                 scale: float = 1.0) -> np.ndarray:
    """AlexNet PCA lighting noise (Lighting.scala:40-60). The eigen
    statistics are on 0-1 pixels; ``scale=255`` for 0-255 pixels."""
    alpha = rng.normal(0, alpha_std, 3).astype(np.float32)
    shift = (LIGHTING_EIGVEC * alpha * LIGHTING_EIGVAL).sum(1) * scale
    return img + shift.reshape(3, 1, 1)


class ColorJitter(Transformer):
    """Random brightness, contrast and saturation in a shuffled order
    (dataset/image/ColorJitter.scala)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.rng = np.random.RandomState(seed)

    def apply(self, it):
        for s in it:
            img = color_jitter_chw(
                np.asarray(s.features[0], np.float32), self.rng,
                self.brightness, self.contrast, self.saturation)
            yield Sample(img, _label(s))


class Lighting(Transformer):
    """AlexNet-style PCA lighting noise (dataset/image/Lighting.scala)
    with ImageNet's RGB eigen vectors and values."""

    _EIGVAL = LIGHTING_EIGVAL
    _EIGVEC = LIGHTING_EIGVEC

    def __init__(self, alpha_std: float = 0.1, seed: int = 0):
        self.alpha_std = alpha_std
        self.rng = np.random.RandomState(seed)

    def apply(self, it):
        for s in it:
            img = lighting_chw(np.asarray(s.features[0], np.float32),
                               self.rng, self.alpha_std)
            yield Sample(img, _label(s))


def parse_idx(buf: bytes) -> np.ndarray:
    """An idx file's unsigned-byte tensor as float32 in its own dims."""
    if len(buf) < 4 or buf[0] or buf[1] or buf[2] != 0x08:
        raise ValueError("not an unsigned-byte idx file")
    ndim = buf[3]
    dims = struct.unpack(f">{ndim}I", buf[4:4 + 4 * ndim])
    return np.frombuffer(buf, np.uint8, count=int(np.prod(dims)),
                         offset=4 + 4 * ndim).reshape(dims) \
        .astype(np.float32)


def idx_parser():
    """The idx parser to use: the native one where the native library
    builds (:mod:`bigdl_tpu_torch.native`), else :func:`parse_idx`;
    both give the same arrays."""
    from bigdl_tpu_torch import native
    return native.parse_idx if native.native_available() else parse_idx


def _read(path: str) -> bytes:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return f.read()


def load_mnist(images_path: str, labels_path: str):
    """MNIST idx files (plain or ``.gz``) -> ``(images [N, 1, 28, 28]
    float32 in 0-255, labels [N] 1-based float32)``, through the native
    idx parser when the native library is available."""
    parse = idx_parser()
    imgs = parse(_read(images_path))
    lbls = parse(_read(labels_path))
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

"""ImageNet-scale input pipeline (counterpart of
``bigdl_tpu.dataset.imagenet``).

The reference feeds ImageNet from a ``<class>/<image>`` folder
(``DataSet.ImageFolder``, dataset/DataSet.scala:408) or from packed
SequenceFiles (``DataSet.SeqFileFolder``, :470-552), with batches built
off the critical path by a thread pool (MTLabeledBGRImgToBatch.scala).
Here: :func:`list_image_folder` scans the class tree;
:class:`ImageRecordWriter` / :func:`read_image_records` are the
crc32c-guarded record shards; :class:`ImageFolderDataSet` decodes and
augments on a pool of Python threads into a bounded queue and splits
the items by process. The copy to the card is
:func:`bigdl_tpu_torch.dataset.prefetch.device_prefetch`.

Decoding (:func:`decode_image`) picks its decoder by the data's first
bytes: binary PPM (``P6``, maxval 255) and 24-bit uncompressed BMP are
decoded here in numpy; every other format (JPEG, PNG, other PPM and
BMP variants) goes through Pillow, imported when such an image is met,
and without Pillow the call raises an ImportError that names it. The
shorter side is resized with :func:`resize_bilinear`, a numpy copy of
Pillow's bilinear resampling (``libImaging/Resample.c``), so the pixels
equal the JAX package's PIL decode bitwise.

Augmentation is the reference recipe (models/inception/Train.scala,
BGRImgCropper.scala): shorter side to ``scale``, random (train) or
center (eval) crop, random horizontal flip, optional color jitter and
PCA lighting, per-channel normalization. Batches are NCHW float32,
labels 1-based by sorted class-folder name (DataSet.scala:425-430).
"""
from __future__ import annotations

import functools
import os
import queue
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.utils.crc32c import masked_crc32c

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "ImageFolderDataSet",
           "ImageRecordWriter", "decode_image", "list_image_folder",
           "read_image_records", "resize_bilinear",
           "write_image_record_shards"]

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm")

# ImageNet RGB statistics (0-255 scale), the reference's defaults
# (BGRImgNormalizer's use in models/inception/Train.scala)
IMAGENET_MEAN = (123.68, 116.779, 103.939)
IMAGENET_STD = (58.393, 57.12, 57.375)


def list_image_folder(root: str) -> Tuple[List[str], np.ndarray, List[str]]:
    """Scan ``root/<class>/<img>`` -> ``(paths, labels, class_names)``:
    class folders sorted by name and numbered from 1
    (DataSet.scala:425-430's LocalImageFiles labeling)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"no class directories under {root}")
    paths, labels = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(_IMG_EXTS):
                paths.append(os.path.join(cdir, fn))
                labels.append(ci + 1)
    return paths, np.asarray(labels, np.float32), classes


# ------------------------------------------------------------- decoding

def _ppm_header(data: bytes):
    """``(width, height, maxval, data offset)`` of a binary PPM."""
    pos, fields = 2, []
    while len(fields) < 3:
        while pos < len(data) and (data[pos:pos + 1].isspace()
                                   or data[pos] == ord("#")):
            if data[pos] == ord("#"):
                while pos < len(data) and data[pos] not in b"\r\n":
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            raise ValueError("malformed PPM header")
        fields.append(int(data[start:pos]))
    if pos >= len(data) or not data[pos:pos + 1].isspace():
        raise ValueError("malformed PPM header")
    return fields[0], fields[1], fields[2], pos + 1


def _decode_ppm(data: bytes, w: int, h: int, offset: int) -> np.ndarray:
    n = w * h * 3
    if len(data) - offset < n:
        raise ValueError("truncated PPM data")
    return np.frombuffer(data, np.uint8, count=n, offset=offset) \
        .reshape(h, w, 3).copy()


def _bmp_info(data: bytes):
    """``(width, height, top_down, data offset)`` of a 24-bit
    uncompressed BMP with a Windows info header, else None."""
    if len(data) < 54:
        return None
    offset, dib = struct.unpack_from("<II", data, 10)
    if dib not in (40, 52, 56, 64, 108, 124):
        return None
    width, height, _planes, bits, compression = struct.unpack_from(
        "<iiHHI", data, 18)
    if bits != 24 or compression != 0 or width <= 0:
        return None
    # Pillow reads a top-down image from the height's high byte
    top_down = data[25] == 0xFF
    if top_down:
        height = 2 ** 32 - struct.unpack_from("<I", data, 22)[0]
    return width, height, top_down, offset


def _decode_bmp(data: bytes, info) -> np.ndarray:
    w, h, top_down, offset = info
    stride = ((w * 24 + 31) >> 3) & ~3
    if len(data) - offset < stride * h:
        raise ValueError("truncated BMP data")
    rows = np.frombuffer(data, np.uint8, count=stride * h, offset=offset) \
        .reshape(h, stride)[:, :w * 3].reshape(h, w, 3)
    if not top_down:
        rows = rows[::-1]
    return np.ascontiguousarray(rows[:, :, ::-1])     # BGR -> RGB


def _pillow_decode(data: bytes) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "this image needs Pillow to decode (JPEG, PNG, or a PPM/BMP "
            "variant other than binary 8-bit PPM and 24-bit uncompressed "
            "BMP), and Pillow is not installed") from e
    import io
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                      np.uint8)


def _decode_rgb(data: bytes) -> np.ndarray:
    """Image bytes -> RGB HWC uint8, the decoder chosen by the magic."""
    if data[:2] == b"P6":
        w, h, maxval, offset = _ppm_header(data)
        if maxval == 255:
            return _decode_ppm(data, w, h, offset)
    elif data[:2] == b"BM":
        info = _bmp_info(data)
        if info is not None:
            return _decode_bmp(data, info)
    return _pillow_decode(data)


_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=256)
def _coefficients(in_size: int, out_size: int):
    """Pillow's bilinear taps for one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): ``(first source index [out], fixed-point
    weights [out, taps])``, read-only."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    ss = 1.0 / filterscale
    taps = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):
        arg = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        w = np.where((x < xmax) & (arg < 1.0), 1.0 - arg, 0.0)
        taps[:, x] = w
        ww += w        # one tap at a time: the C loop's order of sums
    taps = np.where(ww[:, None] != 0.0, taps / np.where(ww == 0.0, 1.0,
                                                        ww)[:, None], taps)
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(taps < 0, np.trunc(-0.5 + taps * one),
                     np.trunc(0.5 + taps * one)).astype(np.int32)
    used = int(xmax.max())
    fixed = np.ascontiguousarray(fixed[:, :used])
    xmin.setflags(write=False)
    fixed.setflags(write=False)
    return xmin, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis`` (0 rows, 1
    columns), clipped to uint8."""
    in_size = img.shape[axis]
    first, fixed = _coefficients(in_size, out_size)
    src = img.astype(np.int32)
    shape = list(img.shape)
    shape[axis] = out_size
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    wshape = [1, 1, 1]
    wshape[axis] = out_size
    for t in range(fixed.shape[1]):
        idx = np.minimum(first + t, in_size - 1)
        acc += np.take(src, idx, axis=axis) * fixed[:, t].reshape(wshape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.resize((width, height), Image.BILINEAR)`` on an RGB HWC
    uint8 array, bitwise: the filter support scaled by the downscale
    factor, the taps normalized then rounded to 22 fractional bits
    (half away from zero), the horizontal pass first and clipped to
    uint8, then the vertical pass; an image already ``(width,
    height)`` comes back as a copy."""
    h, w = img.shape[:2]
    out = img
    if width != w:
        out = _resample_axis(out, width, 1)
    if height != h:
        out = _resample_axis(out, height, 0)
    return out.copy() if out is img else out


def decode_image(data_or_path, *, scale: Optional[int] = None) -> np.ndarray:
    """Image bytes or a path -> RGB HWC uint8, the shorter side resized
    to ``scale`` when given (BGRImage.read's smallest-side resize)."""
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()
    img = _decode_rgb(data)
    if scale is not None:
        h, w = img.shape[:2]
        if w < h:
            nw, nh = scale, max(1, round(h * scale / w))
        else:
            nh, nw = scale, max(1, round(w * scale / h))
        img = resize_bilinear(img, nw, nh)
    return img


# -------------------------------------------------- record format (shards)

_RECORD_MAGIC = b"BTIR"


class ImageRecordWriter:
    """Pack ``(image bytes, label)`` records into a flat shard file (the
    ImageNetSeqFileGenerator analogue).

    Layout: the magic, then per record ``[u32 payload_len][u32
    masked_crc32c(payload)][payload]`` with payload ``[f32 label][u32
    name_len][name utf8][image bytes]`` (TFRecord's length and crc
    framing, so a torn shard is found on read)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(_RECORD_MAGIC)

    def write(self, data: bytes, label: float, name: str = ""):
        nb = name.encode("utf-8")
        payload = struct.pack("<fI", float(label), len(nb)) + nb + bytes(data)
        self.f.write(struct.pack("<II", len(payload),
                                 masked_crc32c(payload)))
        self.f.write(payload)

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_image_records(path: str, *, verify: bool = True
                       ) -> Iterator[Tuple[bytes, float, str]]:
    """Yield ``(image bytes, label, name)`` from an ImageRecordWriter
    shard; a record whose crc does not match raises ValueError."""
    with open(path, "rb") as f:
        if f.read(4) != _RECORD_MAGIC:
            raise ValueError(f"{path}: not an image record file")
        while True:
            hdr = f.read(8)
            if not hdr:
                return
            if len(hdr) < 8:
                raise ValueError(f"{path}: truncated record header")
            ln, crc = struct.unpack("<II", hdr)
            payload = f.read(ln)
            if len(payload) < ln:
                raise ValueError(f"{path}: truncated record payload")
            if verify and masked_crc32c(payload) != crc:
                raise ValueError(f"{path}: record crc mismatch")
            label, name_len = struct.unpack("<fI", payload[:8])
            name = payload[8:8 + name_len].decode("utf-8")
            yield payload[8 + name_len:], label, name


def write_image_record_shards(folder: str, out_dir: str, *,
                              num_shards: int = 8,
                              prefix: str = "imagenet") -> List[str]:
    """ImageFolder -> record shards (ImageNetSeqFileGenerator.scala):
    item ``i`` goes to shard ``i % num_shards``."""
    paths, labels, _ = list_image_folder(folder)
    os.makedirs(out_dir, exist_ok=True)
    shard_paths = [os.path.join(out_dir, f"{prefix}-{i:05d}-of-"
                                f"{num_shards:05d}.btir")
                   for i in range(num_shards)]
    writers = [ImageRecordWriter(p) for p in shard_paths]
    try:
        for i, (p, lbl) in enumerate(zip(paths, labels)):
            with open(p, "rb") as f:
                writers[i % num_shards].write(f.read(), float(lbl),
                                              os.path.basename(p))
    finally:
        for w in writers:
            w.close()
    return shard_paths


# ---------------------------------------------- multi-threaded folder feed


class _Augmenter:
    """Per-sample decode and augmentation: shorter side to ``scale``,
    crop, flip, optional color jitter and PCA lighting, normalization
    -> CHW float32 (BGRImgCropper + HFlip + ColorJitter.scala +
    Lighting.scala + BGRImgNormalizer), drawing from the ``rng`` it is
    given in the JAX package's order."""

    def __init__(self, crop: int, scale: int, train: bool,
                 mean: Sequence[float], std: Sequence[float],
                 color_jitter: bool = False, lighting: bool = False):
        self.crop, self.scale, self.train = crop, scale, train
        self.mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(3, 1, 1)
        self.color_jitter = color_jitter
        self.lighting = lighting

    def __call__(self, raw, rng: np.random.RandomState) -> np.ndarray:
        from bigdl_tpu_torch.dataset.image import (color_jitter_chw,
                                                   lighting_chw)

        img = decode_image(raw, scale=self.scale)
        h, w = img.shape[:2]
        c = self.crop
        if self.train:
            oy = rng.randint(0, h - c + 1)
            ox = rng.randint(0, w - c + 1)
        else:
            oy, ox = (h - c) // 2, (w - c) // 2
        img = img[oy:oy + c, ox:ox + c]
        if self.train and rng.rand() < 0.5:
            img = img[:, ::-1]
        # order="C": a transposed view's astype keeps its strides, and
        # np.stack then hands the card an NHWC batch
        chw = img.transpose(2, 0, 1).astype(np.float32, order="C")
        if self.train and self.color_jitter:
            chw = color_jitter_chw(chw, rng)
        if self.train and self.lighting:
            # this pipeline works on 0-255 pixels
            chw = lighting_chw(chw, rng, scale=255.0)
        return (chw - self.mean) / self.std


class ImageFolderDataSet(AbstractDataSet):
    """Threaded decode and augmentation over an image folder, record
    shards or SequenceFile shards (MTLabeledBGRImgToBatch.scala's
    counterpart).

    Training: ``num_threads`` workers each build whole MiniBatches into
    a bounded queue of ``prefetch``; the order of items comes from one
    shared :class:`_IndexStream`, so every epoch visits each item once
    whatever the threads do, and worker ``t`` augments from
    ``RandomState(seed + t)``. Which worker takes which chunk depends on
    scheduling, so the batches repeat bitwise only at
    ``num_threads=1``. Evaluation: center crops, in item order, through
    a thread pool. ``process_index`` / ``process_count`` split the items
    for multi-host input."""

    # the train pool's _IndexStream never restarts across the optimizer's
    # epoch rollover, so the driver carries a straddling batch's
    # overshoot instead of resetting its record counter
    continuous_stream = True

    def __init__(self, folder: Optional[str] = None, *,
                 record_shards: Optional[Sequence[str]] = None,
                 seq_files: Optional[Sequence[str]] = None,
                 batch_size: int = 32, crop: int = 224, scale: int = 256,
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD,
                 num_threads: int = 8, prefetch: int = 8,
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 0, color_jitter: bool = False,
                 lighting: bool = False):
        sources = [s for s in (folder, record_shards, seq_files)
                   if s is not None]
        if len(sources) != 1:
            raise ValueError(
                "pass exactly one of folder / record_shards / seq_files")
        if folder is not None:
            paths, labels, self.classes = list_image_folder(folder)
            self._items: List = list(zip(paths, labels))
        elif record_shards is not None:
            self.classes = None
            self._items = [(data, label) for shard in record_shards
                           for data, label, _ in read_image_records(shard)]
        else:
            # Hadoop SequenceFile shards, as the reference's
            # ImageNetSeqFileGenerator packs them
            from bigdl_tpu_torch.dataset.seqfile import \
                read_seq_image_records
            self.classes = None
            self._items = [(data, label) for shard in seq_files
                           for data, label, _ in
                           read_seq_image_records(shard)]
        self._total = len(self._items)
        self._items = self._items[process_index::process_count]
        if not self._items:
            raise ValueError("empty input shard")
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.seed = seed
        self._mean, self._std = mean, std
        self._crop, self._scale = crop, scale
        self._color_jitter, self._lighting = color_jitter, lighting
        self._train_pool: Optional[_BatchPool] = None

    def size(self) -> int:
        return self._total

    def local_size(self) -> int:
        return len(self._items)

    def shuffle(self):
        # the train pool's _IndexStream permutes itself at each epoch
        # boundary; nothing to do at the optimizer's rollover
        pass

    def data(self, train: bool = True):
        if train:
            if self._train_pool is None:
                self._train_pool = _BatchPool(
                    self._items, self.batch_size,
                    _Augmenter(self._crop, self._scale, True,
                               self._mean, self._std,
                               color_jitter=self._color_jitter,
                               lighting=self._lighting),
                    num_threads=self.num_threads, prefetch=self.prefetch,
                    seed=self.seed)
            pool = self._train_pool

            def it():
                while True:
                    yield pool.next_batch()
            return it()

        aug = _Augmenter(self._crop, self._scale, False,
                         self._mean, self._std)
        items, bs = self._items, self.batch_size

        def make_batch(start):
            chunk = items[start:start + bs]
            rng = np.random.RandomState(0)  # unused: eval draws nothing
            imgs = np.ascontiguousarray(
                np.stack([aug(raw, rng) for raw, _ in chunk]))
            lbls = np.asarray([lbl for _, lbl in chunk], np.float32)
            return MiniBatch(imgs, lbls)

        def eval_it():
            # ordered, threaded: the reference runs val through the same
            # MT batcher as train (MTLabeledBGRImgToBatch.scala)
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
                window: deque = deque()
                try:
                    for start in range(0, len(items), bs):
                        window.append(ex.submit(make_batch, start))
                        if len(window) > max(2, self.prefetch):
                            yield window.popleft().result()
                    while window:
                        yield window.popleft().result()
                finally:
                    for fut in window:
                        fut.cancel()
        return eval_it()

    def close(self):
        """Stop the training pool's workers."""
        if self._train_pool is not None:
            self._train_pool.close()
            self._train_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _IndexStream:
    """Thread-safe walk over concatenated per-epoch permutations: every
    item index appears once an epoch (the reference's
    CachedDistriDataSet.shuffle, DataSet.scala:240), however many
    workers pull from it."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = n, seed
        self.lock = threading.Lock()
        self.epoch = 0
        self.pos = 0
        self.perm = self._epoch_perm(0)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        # the stream's seed is namespaced so it never equals a worker's
        # augmentation seed (seed + thread index)
        s = zlib.crc32(f"perm:{self.seed}:{epoch}".encode()) & 0xFFFFFFFF
        return np.random.RandomState(s).permutation(self.n)

    def next(self, k: int) -> np.ndarray:
        out = []
        with self.lock:
            while k > 0:
                take = min(k, self.n - self.pos)
                out.append(self.perm[self.pos:self.pos + take])
                self.pos += take
                k -= take
                if self.pos == self.n:
                    self.epoch += 1
                    self.perm = self._epoch_perm(self.epoch)
                    self.pos = 0
        return np.concatenate(out) if len(out) > 1 else out[0]


class _BatchPool:
    """``num_threads`` workers, each building whole batches into a
    bounded ready queue, in the order of a shared :class:`_IndexStream`.
    An unreadable image is replaced by a random other item (the
    reference logs and skips bad JPEGs); ten in a row stop the worker
    and :meth:`next_batch` raises once no worker is left."""

    def __init__(self, items, batch_size, augmenter, *, num_threads,
                 prefetch, seed):
        self.items = items
        self.batch_size = batch_size
        self.augmenter = augmenter
        self.ready: queue.Queue = queue.Queue(maxsize=max(2, prefetch))
        self.stop = threading.Event()
        self.stream = _IndexStream(len(items), seed)
        self.threads = [
            threading.Thread(target=self._worker, args=(seed + t,),
                             daemon=True)
            for t in range(num_threads)]
        for t in self.threads:
            t.start()

    def _sample(self, i, rng):
        """The augmented image and label of item ``i``, resampling an
        unreadable one."""
        n = len(self.items)
        raw, lbl = self.items[i]
        last_err = None
        for _attempt in range(10):
            try:
                return self.augmenter(raw, rng), lbl
            except Exception as e:
                last_err = e
                raw, lbl = self.items[int(rng.randint(0, n))]
        raise RuntimeError("10 consecutive unreadable images") from last_err

    def _worker(self, seed):
        rng = np.random.RandomState(seed)
        while not self.stop.is_set():
            idxs = self.stream.next(self.batch_size)
            imgs, lbls = [], []
            for i in idxs:
                if self.stop.is_set():
                    return
                img, lbl = self._sample(i, rng)
                imgs.append(img)
                lbls.append(lbl)
            batch = MiniBatch(np.ascontiguousarray(np.stack(imgs)),
                              np.asarray(lbls, np.float32))
            while not self.stop.is_set():
                try:
                    self.ready.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next_batch(self) -> MiniBatch:
        while True:
            try:
                return self.ready.get(timeout=1.0)
            except queue.Empty:
                if self.stop.is_set() or not any(
                        t.is_alive() for t in self.threads):
                    raise RuntimeError("batch pool stopped")

    def close(self):
        self.stop.set()
        # drain so producers blocked on put() observe stop
        try:
            while True:
                self.ready.get_nowait()
        except queue.Empty:
            pass
        for t in self.threads:
            t.join(timeout=2.0)

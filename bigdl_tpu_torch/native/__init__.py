"""The native C++ host library (counterpart of ``bigdl_tpu.native``):
CRC32C, the MNIST idx and CIFAR-10 binary parsers, and a multi-threaded
augmenting batch loader that keeps host preprocessing off the Python
GIL, bound with ``ctypes``.

The sources are the port's own (``src/crc32c.cpp``, ``src/dataloader.cpp``,
copies of the JAX package's). Nothing compiles at import: the first
:func:`load_library` builds them with ``g++`` (``$CXX`` if set) and the
JAX package's flags into ``_build/libbigdl_torch_native-<hash>.so``,
where the hash covers the sources, the flags and the compiler path. The
build writes a temporary name and renames it into place, so processes
that build at once (test workers) never load a half-written file. A
failed build raises :class:`NativeBuildError` with g++'s output;
:func:`native_available` is False then, and callers choose another
path, as in the JAX package. The loaders never fall back on their own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["CXXFLAGS", "NativeBatchLoader", "NativeBatchLoaderU8",
           "NativeBuildError", "build_library", "library_path",
           "load_library", "native_available", "native_crc32c",
           "parse_cifar", "parse_idx"]

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "src"
BUILD_DIR = _HERE / "_build"
SOURCES = ("crc32c.cpp", "dataloader.cpp")
#: the JAX package's Makefile flags
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: serializes next_batch against close on a loader whose construction
#: raised before its own lock existed
_NULL_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native library could not be built (no compiler, or g++
    failed: its output is in the message)."""


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("no C++ compiler (set CXX or put g++ on "
                               "the PATH) to build the native library")
    return cxx


def library_path() -> Path:
    """Where the library of the current sources and compiler lives."""
    cxx = _compiler()
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(cxx.encode())
    return BUILD_DIR / f"libbigdl_torch_native-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the library unless it is built; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f".{path.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CXXFLAGS, "-o", str(tmp),
           *(str(SRC_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"building the native library failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)      # atomic: another builder's is equal
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def _declare(lib: ctypes.CDLL) -> None:
    vp, fp, c64, ci = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                       ctypes.c_int64, ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bigdl_crc32c.restype = ctypes.c_uint32
    lib.bigdl_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_uint32]
    lib.bigdl_parse_idx.restype = ci
    lib.bigdl_parse_idx.argtypes = [ctypes.c_char_p, c64, fp, c64,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.bigdl_parse_cifar.restype = ci
    lib.bigdl_parse_cifar.argtypes = [ctypes.c_char_p, c64, fp, fp, c64]
    geometry = [c64, ci, ci, ci, ci, ci, ci, ci, ci, ci]
    lib.bigdl_loader_create.restype = vp
    lib.bigdl_loader_create.argtypes = [fp, fp, *geometry, fp, fp, ci, ci,
                                        ctypes.c_uint64]
    lib.bigdl_loader_next.restype = ci
    lib.bigdl_loader_next.argtypes = [vp, vp, vp]
    lib.bigdl_loader_destroy.restype = None
    lib.bigdl_loader_destroy.argtypes = [vp]
    lib.bigdl_loader_u8_create.restype = vp
    lib.bigdl_loader_u8_create.argtypes = [u8p, fp, *geometry, ci, ci,
                                           ctypes.c_uint64]
    lib.bigdl_loader_u8_next.restype = ci
    lib.bigdl_loader_u8_next.argtypes = [vp, vp, vp]
    lib.bigdl_loader_u8_destroy.restype = None
    lib.bigdl_loader_u8_destroy.argtypes = [vp]


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded library, building it first when needed; with
    ``build=False`` only an already built one is loaded (None if there
    is none). A failed build raises :class:`NativeBuildError`."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            if not build:
                return None
            path = build_library()
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
    from bigdl_tpu_torch.utils import crc32c
    crc32c.adopt_native(lib)
    return lib


def native_available() -> bool:
    """True when the library is built and loads (building it if needed);
    False when it cannot build or load."""
    try:
        load_library()
    except (NativeBuildError, OSError):
        return False
    return True


def native_crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data`` continuing from ``crc``, in C++."""
    data = bytes(data)
    return load_library().bigdl_crc32c(data, len(data), crc)


def parse_idx(data: bytes) -> np.ndarray:
    """An MNIST idx buffer (unsigned bytes) as float32 in its own dims;
    raises ValueError with the parser's code on a malformed buffer."""
    lib = load_library()
    data = bytes(data)
    cap = len(data)  # at most one value a byte
    out = np.empty(cap, np.float32)
    dims = np.zeros(4, np.int32)
    ndim = ctypes.c_int32(0)
    rc = lib.bigdl_parse_idx(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(ndim))
    if rc != 0:
        raise ValueError(f"idx parse failed (code {rc})")
    shape = tuple(int(d) for d in dims[:ndim.value])
    return out[:int(np.prod(shape))].reshape(shape)


def parse_cifar(data: bytes, max_records: int = 1 << 30):
    """CIFAR-10 binary records -> ``(images [N, 3, 32, 32] float32,
    labels [N] 1-based float32)``; a partial record at the end is
    dropped."""
    lib = load_library()
    data = bytes(data)
    rec = 1 + 3 * 32 * 32
    n = min(len(data) // rec, max_records)
    imgs = np.empty((n, 3, 32, 32), np.float32)
    lbls = np.empty((n,), np.float32)
    got = lib.bigdl_parse_cifar(
        data, len(data), imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lbls.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    return imgs[:got], lbls[:got]


class _Loader:
    """The shared half of the two loaders: the C handle, the batch
    buffers, close."""

    _prefix = ""
    _dtype = np.float32

    def _start(self, lib, images, labels, batch_size, crop, pad):
        self._lib = lib
        self.images, self.labels = images, labels
        n, c, h, w = images.shape
        if n <= 0:
            raise ValueError(f"{type(self).__name__} needs a non-empty "
                             "dataset")
        if len(labels) < n:
            raise ValueError(
                f"labels ({len(labels)}) shorter than images ({n}) — C++ "
                "workers index labels[0:n)")
        ch, cw = crop or (h, w)
        self.batch_size = batch_size
        self.out_shape = (batch_size, c, ch, cw)
        return n, c, h, w, ch, cw, pad, batch_size

    def next_batch(self):
        """The next ``(images, labels)`` batch the workers made."""
        imgs = np.empty(self.out_shape, self._dtype)
        lbls = np.empty((self.batch_size,), np.float32)
        with self._lock:
            if not self._handle:
                raise RuntimeError("loader is closed")
            got = getattr(self._lib, f"bigdl_loader{self._prefix}_next")(
                self._handle, imgs.ctypes.data_as(ctypes.c_void_p),
                lbls.ctypes.data_as(ctypes.c_void_p))
        if got == 0:  # stopping: the buffers are uninitialized
            raise RuntimeError("loader stopped")
        return imgs, lbls

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self) -> None:
        """Stop and join the C++ workers."""
        with getattr(self, "_lock", _NULL_LOCK):
            if getattr(self, "_handle", None):
                getattr(self._lib,
                        f"bigdl_loader{self._prefix}_destroy")(self._handle)
                self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBatchLoader(_Loader):
    """Threaded augmenting loader over an in-memory ``[N, C, H, W]``
    dataset (MTLabeledBGRImgToBatch's role): float32 batches, random
    pad-crop, horizontal flip and normalize in C++ threads. In training
    mode each worker draws from its own ``mt19937_64(seed + thread)``,
    so batches of several threads arrive in any order; in evaluation
    mode the rows run in order from 0, centre-cropped."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, crop: Optional[tuple] = None,
                 pad: int = 0, flip: bool = True, train: bool = True,
                 mean=None, std=None, num_threads: int = 4,
                 prefetch: int = 4, seed: int = 0):
        lib = load_library()
        images = np.ascontiguousarray(images, np.float32)
        labels = np.ascontiguousarray(labels, np.float32)
        if images.shape[1] > 8:
            raise ValueError("NativeBatchLoader supports at most 8 "
                             "channels (mean/std are fixed-size in C++)")
        geometry = self._start(lib, images, labels, batch_size, crop, pad)
        c = images.shape[1]
        self._mean = np.asarray(mean if mean is not None else [0.0] * c,
                                np.float32)
        self._std = np.asarray(std if std is not None else [1.0] * c,
                               np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        self._handle = lib.bigdl_loader_create(
            images.ctypes.data_as(fp), labels.ctypes.data_as(fp), *geometry,
            int(flip), int(train), self._mean.ctypes.data_as(fp),
            self._std.ctypes.data_as(fp), num_threads, prefetch, seed)
        if not self._handle:
            raise ValueError("bigdl_loader_create rejected the config")
        self._lock = threading.Lock()


class NativeBatchLoaderU8(_Loader):
    """The uint8 loader: crop and flip only, no normalize; the batch
    crosses to the card at a quarter of float32's bytes and ``(x - mean)
    / std`` runs there."""

    _prefix = "_u8"
    _dtype = np.uint8

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, crop: Optional[tuple] = None,
                 pad: int = 0, flip: bool = True, train: bool = True,
                 num_threads: int = 4, prefetch: int = 4, seed: int = 0):
        lib = load_library()
        images = np.ascontiguousarray(images, np.uint8)
        labels = np.ascontiguousarray(labels, np.float32)
        geometry = self._start(lib, images, labels, batch_size, crop, pad)
        self._handle = lib.bigdl_loader_u8_create(
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            *geometry, int(flip), int(train), num_threads, prefetch, seed)
        if not self._handle:
            raise ValueError("bigdl_loader_u8_create rejected the config")
        self._lock = threading.Lock()

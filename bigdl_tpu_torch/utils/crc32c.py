"""CRC32C (Castagnoli) with TFRecord masking (counterpart of
``bigdl_tpu.visualization.crc32c``; the reference's netty Crc32c.java).

The image record shards (:mod:`bigdl_tpu_torch.dataset.imagenet`) guard
every payload with :func:`masked_crc32c`. A payload of a few hundred
kilobytes (one image) is checksummed in numpy: the data is cut into
rows of ``_ROW`` bytes, every row's CRC register is run at once, one
byte column a step, and the rows' registers are folded together in
order through the linear map "append ``_ROW`` zero bytes"
(``crc(a || b) = shift_len(b)(crc(a)) ^ crc(b)`` with a zero start
register). A short payload and the tail after the last whole row go
through the byte-at-a-time table, which is the reference.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["crc32c", "masked_crc32c", "unmask"]

_POLY = 0x82F63B78  # reversed CRC-32C polynomial
_MASK_DELTA = 0xA282EAD8
_ROW = 1024
_VECTOR_MIN = 8 * _ROW


def _make_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()
_TABLE_NP = np.asarray(_TABLE, np.uint32)
#: per byte lane k, the register after ``_ROW`` zero bytes from a
#: register whose lane k holds the index (built on first use)
_SHIFT: Optional[np.ndarray] = None


def _update(crc: int, data) -> int:
    """The raw register after ``data`` from register ``crc``."""
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _shift_tables() -> np.ndarray:
    global _SHIFT
    if _SHIFT is None:
        # the 32 basis registers through _ROW zero bytes, all at once
        reg = (np.uint32(1) << np.arange(32, dtype=np.uint32))
        for _ in range(_ROW):
            reg = _TABLE_NP[reg & 0xFF] ^ (reg >> 8)
        lanes = np.zeros((4, 256), np.uint32)
        for lane in range(4):
            for bit in range(8):
                on = (np.arange(256) >> bit) & 1 == 1
                lanes[lane, on] ^= reg[8 * lane + bit]
        _SHIFT = lanes
    return _SHIFT


def _update_rows(crc: int, data: bytes) -> int:
    rows = len(data) // _ROW
    grid = np.frombuffer(data, np.uint8, count=rows * _ROW).reshape(
        rows, _ROW)
    reg = np.zeros(rows, np.uint32)
    for j in range(_ROW):
        reg = _TABLE_NP[(reg ^ grid[:, j]) & 0xFF] ^ (reg >> 8)
    shift = _shift_tables()
    for r in reg.tolist():
        crc = int(shift[0, crc & 0xFF] ^ shift[1, (crc >> 8) & 0xFF]
                  ^ shift[2, (crc >> 16) & 0xFF]
                  ^ shift[3, crc >> 24]) ^ r
    return _update(crc, memoryview(data)[rows * _ROW:])


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data``, continuing from ``crc``."""
    reg = crc ^ 0xFFFFFFFF
    data = bytes(data)
    if len(data) >= _VECTOR_MIN:
        reg = _update_rows(reg, data)
    else:
        reg = _update(reg, data)
    return reg ^ 0xFFFFFFFF


#: the CRC a masked crc reads: the numpy one, or the native library's
#: once it is loaded and checked (:func:`adopt_native`)
_crc_impl = crc32c


def adopt_native(lib) -> bool:
    """Take the native library's CRC (``bigdl_crc32c`` of ``lib``) for
    :func:`masked_crc32c` if it gives the check value on
    ``b"123456789"``; returns whether it did. The native library calls
    this when it loads; importing this module loads it only where it is
    built already (nothing compiles here)."""
    global _crc_impl
    if lib.bigdl_crc32c(b"123456789", 9, 0) != 0xE3069283:
        return False
    _crc_impl = lambda data: lib.bigdl_crc32c(bytes(data), len(data), 0)
    return True


def masked_crc32c(data: bytes) -> int:
    """TFRecord masked crc: rotate right 15 then add the mask delta."""
    crc = _crc_impl(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot << 15) | (rot >> 17)) & 0xFFFFFFFF


def _try_native() -> None:
    """Bind the native CRC when the library is already built."""
    from bigdl_tpu_torch import native
    try:
        native.load_library(build=False)
    except (native.NativeBuildError, OSError):
        pass


_try_native()

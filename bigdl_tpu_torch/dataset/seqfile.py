"""Hadoop SequenceFile wire compatibility, no Hadoop dependency
(counterpart of ``bigdl_tpu.dataset.seqfile``; a file written by either
package reads in the other, and the same inputs give the same bytes).

The reference's ImageNet path reads Hadoop SequenceFiles of
``<Text key, Text value>`` where key is ``"name\\nlabel"`` (or just the
label) and value is the raw JPEG bytes — written by
models/utils/ImageNetSeqFileGenerator.scala and read by
dataset/DataSet.scala:470-552 (SeqFileFolder.files / readLabel /
readName). This module implements the documented on-disk format
(header SEQ+version, vint-prefixed Writable payloads, sync-marker
escapes) so datasets ALREADY packed for the reference load here
unchanged, and shards packed here load in the reference.

Supported: version ≥ 5, uncompressed record framing, Text and
BytesWritable payloads — exactly what the reference's generator
produces. Compressed files fail fast with the codec name.
"""
from __future__ import annotations

import os
import struct

from typing import Iterator, List, Tuple

__all__ = ["SequenceFileWriter", "read_seq_image_records",
           "read_sequence_file", "write_seq_image_shards"]

_TEXT = b"org.apache.hadoop.io.Text"
_BYTES = b"org.apache.hadoop.io.BytesWritable"
_SYNC_INTERVAL = 2000  # bytes between sync markers (Hadoop default ~2k)


# ------------------------------------------------------- Hadoop varints

def _write_vint(i: int) -> bytes:
    """WritableUtils.writeVInt/VLong."""
    if -112 <= i <= 127:
        return struct.pack("b", i)
    length = -112
    if i < 0:
        i ^= -1  # take one's complement
        length = -120
    tmp = i
    while tmp != 0:
        tmp >>= 8
        length -= 1
    out = [struct.pack("b", length)]
    length = -(length + 120) if length < -120 else -(length + 112)
    for idx in range(length - 1, -1, -1):
        out.append(bytes([(i >> (8 * idx)) & 0xFF]))
    return b"".join(out)


def _read_vint(buf: bytes, pos: int) -> Tuple[int, int]:
    """-> (value, new_pos)."""
    first = struct.unpack_from("b", buf, pos)[0]
    pos += 1
    if first >= -112:
        return first, pos
    negative = first < -120
    length = -(first + 120) if negative else -(first + 112)
    i = 0
    for _ in range(length):
        i = (i << 8) | buf[pos]
        pos += 1
    return (i ^ -1) if negative else i, pos


def _text(payload: bytes) -> bytes:
    """Text Writable serialization: vint byte-length + utf8 bytes."""
    return _write_vint(len(payload)) + payload


def _decode_writable(cls: bytes, raw: bytes) -> bytes:
    """Writable bytes -> content bytes for the two supported classes."""
    if cls == _TEXT:
        n, pos = _read_vint(raw, 0)
        return raw[pos:pos + n]
    if cls == _BYTES:
        (n,) = struct.unpack_from(">i", raw, 0)
        return raw[4:4 + n]
    raise ValueError(f"unsupported Writable class {cls.decode()}")


# ------------------------------------------------------------- writer

class SequenceFileWriter:
    """Uncompressed ``<Text, Text>`` SequenceFile writer — enough to
    produce files Hadoop/Spark (and the reference's SeqFileFolder)
    read back byte-for-byte. The classes are fixed at Text/Text because
    ``append`` frames payloads with Text's vint serialization (what the
    reference's generator writes)."""

    def __init__(self, path: str, *, sync_seed: int = 0):
        import hashlib
        self._f = open(path, "wb")
        # any 16 bytes work as the sync marker; derive deterministically
        self.sync = hashlib.md5(
            f"bigdl_tpu-seq-{sync_seed}-{os.path.basename(path)}"
            .encode()).digest()
        f = self._f
        f.write(b"SEQ\x06")
        f.write(_text(_TEXT))
        f.write(_text(_TEXT))
        f.write(b"\x00\x00")          # no compression, no block compression
        f.write(struct.pack(">i", 0))  # empty metadata
        f.write(self.sync)
        self._since_sync = 0

    def append(self, key: bytes, value: bytes) -> None:
        kw, vw = _text(key), _text(value)
        if self._since_sync >= _SYNC_INTERVAL:
            self._f.write(struct.pack(">i", -1))
            self._f.write(self.sync)
            self._since_sync = 0
        rec = struct.pack(">ii", len(kw) + len(vw), len(kw)) + kw + vw
        self._f.write(rec)
        self._since_sync += len(rec)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ------------------------------------------------------------- reader

def _read_exact(f, n: int, path: str) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError(f"{path}: truncated SequenceFile")
    return b


def _read_vint_f(f, path: str) -> int:
    first = struct.unpack("b", _read_exact(f, 1, path))[0]
    if first >= -112:
        return first
    negative = first < -120
    length = -(first + 120) if negative else -(first + 112)
    i = 0
    for b in _read_exact(f, length, path):
        i = (i << 8) | b
    return (i ^ -1) if negative else i


def read_sequence_file(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key_content, value_content) from one SequenceFile,
    STREAMING record by record (ImageNet-scale shards never live whole
    in RAM); the Writable framing (Text vint / BytesWritable length) is
    stripped."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic[:3] != b"SEQ":
            raise ValueError(f"{path}: not a SequenceFile (no SEQ magic)")
        version = magic[3]
        if version < 5:
            raise ValueError(f"{path}: SequenceFile version {version} "
                             "too old (need >= 5)")
        key_class = _read_exact(f, _read_vint_f(f, path), path)
        value_class = _read_exact(f, _read_vint_f(f, path), path)
        compressed, block_compressed = _read_exact(f, 2, path)
        if compressed or block_compressed:
            raise ValueError(
                f"{path}: compressed SequenceFiles unsupported; "
                "re-pack uncompressed")
        if version >= 6:  # the metadata block exists only from v6 on
            (meta_count,) = struct.unpack(">i", _read_exact(f, 4, path))
            for _ in range(meta_count):  # Text key/value pairs
                for _ in range(2):
                    _read_exact(f, _read_vint_f(f, path), path)
        sync = _read_exact(f, 16, path)
        while True:
            head = f.read(4)
            if len(head) < 4:
                return  # clean EOF
            (rec_len,) = struct.unpack(">i", head)
            if rec_len == -1:  # sync escape
                if _read_exact(f, 16, path) != sync:
                    raise ValueError(f"{path}: corrupt sync marker")
                continue
            (key_len,) = struct.unpack(">i", _read_exact(f, 4, path))
            # recordLength covers the serialized key+value bytes only
            # (the two length ints are outside it)
            key_raw = _read_exact(f, key_len, path)
            value_raw = _read_exact(f, rec_len - key_len, path)
            yield (_decode_writable(key_class, key_raw),
                   _decode_writable(value_class, value_raw))


# ---------------------------------------------- the reference's ImageNet

def read_seq_image_records(path: str
                           ) -> Iterator[Tuple[bytes, float, str]]:
    """BigDL's ImageNet SequenceFile convention -> (jpeg_bytes, label,
    name): key Text is "name\\nlabel" (readName/readLabel,
    DataSet.scala:495-515) or just "label"; value Text is the image."""
    for key, value in read_sequence_file(path):
        parts = key.decode().split("\n")
        name, label = (parts[0], parts[1]) if len(parts) >= 2 \
            else ("", parts[0])
        yield value, float(label), name


def write_seq_image_shards(folder: str, out_dir: str, *,
                           num_shards: int = 8,
                           prefix: str = "imagenet",
                           seed: int = 0) -> List[str]:
    """Pack an ImageFolder tree into Hadoop-compatible .seq shards (the
    reference's ImageNetSeqFileGenerator.scala:1 output format)."""
    import numpy as np

    from bigdl_tpu_torch.dataset.imagenet import list_image_folder

    paths, labels, _ = list_image_folder(folder)
    order = np.random.RandomState(seed).permutation(len(paths))
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for s in range(num_shards):
        out = os.path.join(out_dir, f"{prefix}-{s:05d}.seq")
        with SequenceFileWriter(out, sync_seed=seed + s) as w:
            for i in order[s::num_shards]:
                with open(paths[i], "rb") as f:
                    data = f.read()
                name = os.path.basename(paths[i])
                key = f"{name}\n{int(labels[i])}".encode()
                w.append(key, data)
        outs.append(out)
    return outs

"""Hadoop SequenceFiles, the port against the JAX package: the vint wire
vectors, a file written by either package read in the other (sync
escapes, label-only keys, a version-5 header and metadata written by
hand), the same inputs written to byte-identical files, the header
checks, and the ImageNet shards of a folder. Everything bitwise."""
import os
import struct

import numpy as np
import pytest
from PIL import Image

from bigdl_tpu.dataset import seqfile as jseq
from bigdl_tpu_torch.dataset import seqfile

PACKAGES = {"port": seqfile, "jax": jseq}


def _records(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return [(f"key-{i}".encode(), rng.bytes(rng.randint(0, 400)))
            for i in range(n)]


@pytest.mark.parametrize("value", [0, 1, 127, -112, -1, 128, 150, 255, 256,
                                   65536, -150, -(2 ** 31), 2 ** 40])
def test_vints_match(value):
    wire = seqfile._write_vint(value)
    assert wire == jseq._write_vint(value)
    assert seqfile._read_vint(wire, 0) == jseq._read_vint(wire, 0) \
        == (value, len(wire))


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_file_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                          reader):
    path = str(tmp_path / "a.seq")
    records = _records()
    with PACKAGES[writer].SequenceFileWriter(path, sync_seed=3) as w:
        for k, v in records:
            w.append(k, v)
    with open(path, "rb") as f:
        assert f.read().count(b"\xff\xff\xff\xff") >= 1   # sync escapes
    assert list(PACKAGES[reader].read_sequence_file(path)) == records


def test_the_same_inputs_give_byte_identical_files(tmp_path):
    records = _records(seed=1)
    out = []
    for name, pkg in PACKAGES.items():
        os.makedirs(tmp_path / name)
        path = str(tmp_path / name / "shard.seq")
        with pkg.SequenceFileWriter(path, sync_seed=9) as w:
            for k, v in records:
                w.append(k, v)
        with open(path, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]


def test_version5_header_with_metadata_and_bytes_values(tmp_path):
    """A hand-built file: version 5 (no metadata block) with a
    BytesWritable value class, and version 6 with two metadata pairs."""
    text, raw = b"org.apache.hadoop.io.Text", \
        b"org.apache.hadoop.io.BytesWritable"
    sync = bytes(range(16))
    key, value = seqfile._text(b"k1"), struct.pack(">i", 3) + b"abc"
    rec = struct.pack(">ii", len(key) + len(value), len(key)) + key + value
    v5 = b"SEQ\x05" + seqfile._text(text) + seqfile._text(raw) \
        + b"\x00\x00" + sync + rec
    meta = struct.pack(">i", 2) + b"".join(
        seqfile._text(t) for t in (b"a", b"1", b"b", b"2"))
    v6 = b"SEQ\x06" + seqfile._text(text) + seqfile._text(raw) \
        + b"\x00\x00" + meta + sync + rec
    for i, blob in enumerate((v5, v6)):
        path = tmp_path / f"v{i}.seq"
        path.write_bytes(blob)
        assert list(seqfile.read_sequence_file(str(path))) \
            == list(jseq.read_sequence_file(str(path))) == [(b"k1", b"abc")]


@pytest.mark.parametrize("blob,match", [
    (b"NOTASEQFILE", "SEQ magic"),
    (b"SEQ\x04", "too old"),
    (b"SEQ\x06" + bytes([25]) + b"org.apache.hadoop.io.Text"
     + bytes([25]) + b"org.apache.hadoop.io.Text" + b"\x01\x00", "compressed"),
    (b"SEQ\x06" + bytes([25]) + b"org.apache", "truncated"),
])
def test_header_checks_raise_as_the_jax_package_does(tmp_path, blob, match):
    path = tmp_path / "bad.seq"
    path.write_bytes(blob)
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match=match):
            list(pkg.read_sequence_file(str(path)))


def test_label_only_and_named_keys_read_alike(tmp_path):
    path = str(tmp_path / "x.seq")
    with seqfile.SequenceFileWriter(path) as w:
        w.append(b"7", b"payload")
        w.append(b"n.jpg\n3", b"img")
    want = [(b"payload", 7.0, ""), (b"img", 3.0, "n.jpg")]
    assert list(seqfile.read_seq_image_records(path)) == want
    assert list(jseq.read_seq_image_records(path)) == want


def test_image_shards_of_a_folder_are_byte_identical(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "f"
    for c in ("ant", "bee"):
        os.makedirs(root / c)
        for i in range(5):
            Image.fromarray(rng.randint(0, 256, (9, 7, 3), np.uint8)).save(
                root / c / f"{i}.{('ppm', 'bmp', 'png')[i % 3]}")
    got = seqfile.write_seq_image_shards(str(root), str(tmp_path / "p"),
                                         num_shards=3, seed=4)
    want = jseq.write_seq_image_shards(str(root), str(tmp_path / "j"),
                                       num_shards=3, seed=4)
    records = []
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        with open(g, "rb") as a, open(w, "rb") as b:
            assert a.read() == b.read()
        assert list(seqfile.read_seq_image_records(w)) \
            == list(jseq.read_seq_image_records(g))
        records += list(seqfile.read_seq_image_records(g))
    assert sorted(r[2] for r in records) == sorted(
        f"{i}.{('ppm', 'bmp', 'png')[i % 3]}" for i in range(5) for _ in "ab")
    assert sorted(r[1] for r in records) == [1.0] * 5 + [2.0] * 5

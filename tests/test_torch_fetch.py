"""The port's corpus fetchers (``bigdl_tpu_torch.dataset.fetch``), the
recipes' download-if-missing, and the record-shard generator, against
the JAX package's on fixtures the tests write. Nothing here touches a
network: downloads come from ``file://`` mirrors or a monkeypatched
``urlretrieve``."""
import gzip
import io
import os
import struct
import tarfile
import urllib.request

import numpy as np
import pytest

import bigdl_tpu.dataset.fetch as jfetch
from bigdl_tpu.models import _cli as jcli
from bigdl_tpu.tools import imagenet_seqfile_generator as jgen
from bigdl_tpu_torch import faults
from bigdl_tpu_torch.dataset import fetch
from bigdl_tpu_torch.models import _cli
from bigdl_tpu_torch.models.lenet import train as lenet_train
from bigdl_tpu_torch.models.rnn import train as rnn_train
from bigdl_tpu_torch.tools import imagenet_seqfile_generator as gen


def _write_idx(folder, rng, n=5, prefix="train"):
    imgs = rng.randint(0, 255, (n, 28, 28)).astype(np.uint8)
    lbls = rng.randint(0, 10, n).astype(np.uint8)
    with gzip.open(folder / f"{prefix}-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(folder / f"{prefix}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lbls.tobytes())
    return imgs, lbls


def test_mnist_idx_gzip_equals_jax(tmp_path):
    imgs, lbls = _write_idx(tmp_path, np.random.RandomState(0))
    for name in ("extract_mnist_images", "extract_mnist_labels"):
        kind = "images-idx3" if "images" in name else "labels-idx1"
        path = str(tmp_path / f"train-{kind}-ubyte.gz")
        got, want = getattr(fetch, name)(path), getattr(jfetch, name)(path)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    gi, gl = fetch.mnist_read_data_sets(str(tmp_path), "train")
    np.testing.assert_array_equal(gi, imgs)
    np.testing.assert_array_equal(gl, lbls)
    with pytest.raises(ValueError, match="bad idx magic"):
        fetch.extract_mnist_labels(str(tmp_path /
                                       "train-images-idx3-ubyte.gz"))


def test_maybe_download_skips_existing_and_lands_from_a_mirror(tmp_path):
    p = tmp_path / "cached.bin"
    p.write_bytes(b"seeded")
    missing = (tmp_path / "no-such-mirror" / "x").as_uri()
    assert fetch.maybe_download("cached.bin", str(tmp_path), missing) \
        == str(p)
    assert p.read_bytes() == b"seeded"
    src = tmp_path / "mirror.bin"
    src.write_bytes(b"payload")
    work = tmp_path / "work"
    (work / "a.bin.part").parent.mkdir()
    (work / "a.bin.part").write_bytes(b"stale half")
    got = fetch.maybe_download("a.bin", str(work), src.as_uri())
    assert open(got, "rb").read() == b"payload"
    assert sorted(os.listdir(work)) == ["a.bin"]   # the stale part is gone


def test_a_sha256_mismatch_never_lands_in_either_package(tmp_path,
                                                         monkeypatch):
    import hashlib

    def fake_retrieve(url, dst):
        with open(dst, "wb") as f:
            f.write(b"payload")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    want = hashlib.sha256(b"payload").hexdigest()
    for mod, sub in ((fetch, "port"), (jfetch, "jax")):
        d = tmp_path / sub
        got = mod.maybe_download("a.bin", str(d), "http://x/a.bin",
                                 sha256=want)
        assert open(got, "rb").read() == b"payload"
        with pytest.raises(IOError, match="sha256 mismatch"):
            mod.maybe_download("b.bin", str(d), "http://x/b.bin",
                               sha256="0" * 64, attempts=2)
        assert sorted(os.listdir(d)) == ["a.bin"]


def test_the_download_fault_point_fires_and_the_retry_recovers(
        tmp_path, monkeypatch):
    calls = []

    def fake_retrieve(url, dst):
        calls.append(url)
        with open(dst, "wb") as f:
            f.write(b"payload")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    with faults.armed("fetch/download=nth:1,raise:OSError") as schedule:
        got = fetch.maybe_download("a.bin", str(tmp_path), "http://x/a")
    assert open(got, "rb").read() == b"payload"
    assert schedule.total_fired() == 1 and len(calls) == 1
    with faults.armed("fetch/download=nth:1-2,raise:OSError"):
        with pytest.raises(OSError):
            fetch.maybe_download("b.bin", str(tmp_path), "http://x/b",
                                 attempts=2)
    assert not (tmp_path / "b.bin").exists()


def test_the_parsers_equal_jax(tmp_path):
    for cat in ("sci.space", "alt.atheism"):
        d = tmp_path / "news" / cat
        d.mkdir(parents=True)
        (d / "101").write_bytes(f"doc {cat}\nline two \xe9".encode(
            "latin-1"))
        (d / "7").write_text("short")
        (d / ".DS_Store").write_text("junk")
        (d / "backup~").write_text("junk")
    root = str(tmp_path / "news")
    assert fetch.parse_news20_tree(root) == jfetch.parse_news20_tree(root)
    assert len(fetch.parse_news20_tree(root)) == 4
    glove = tmp_path / "glove.6B.50d.txt"
    glove.write_text("the 0.1 0.2 0.3\ncat -1.0 2.0 3.5\n\n")
    assert fetch.parse_glove_txt(str(glove)) == \
        jfetch.parse_glove_txt(str(glove))
    ratings = tmp_path / "ratings.dat"
    ratings.write_text("1::1193::5::978300760\n\n2::661::3::978302109\n")
    got = fetch.parse_movielens_ratings(str(ratings))
    want = jfetch.parse_movielens_ratings(str(ratings))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_an_interrupted_extraction_leaves_nothing(tmp_path):
    final = tmp_path / "corpus"

    def boom(dst):
        os.makedirs(os.path.join(dst, "partial"))
        raise RuntimeError("disk full")

    with pytest.raises(RuntimeError, match="disk full"):
        fetch._atomic_extract(str(final), boom)
    assert not final.exists() and list(tmp_path.iterdir()) == []

    def ok(dst):
        os.makedirs(os.path.join(dst, "root"))
        with open(os.path.join(dst, "root", "f.txt"), "w") as f:
            f.write("x")

    fetch._atomic_extract(str(final), ok)
    assert (final / "f.txt").read_text() == "x"


def _news20_tgz(path):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        data = b"From: a@b\n\nhello serving"
        info = tarfile.TarInfo("20_newsgroups/alt.atheism/49960")
        info.size = len(data)
        t.addfile(info, io.BytesIO(data))
    path.write_bytes(buf.getvalue())


def test_the_news20_pin_refuses_a_changed_tarball(tmp_path, monkeypatch):
    monkeypatch.delenv(fetch.NEWS20_SHA256_ENV, raising=False)
    good = tmp_path / "good.tar.gz"
    _news20_tgz(good)
    payload = {"bytes": good.read_bytes()}

    def fake_retrieve(url, dst):
        with open(dst, "wb") as f:
            f.write(payload["bytes"])

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    src = tmp_path / "news20"
    texts = fetch.get_news20(str(src) + os.sep)
    assert texts == [("From: a@b\n\nhello serving", 1)]
    tar, sidecar = src / "20news-19997.tar.gz", \
        src / "20news-19997.tar.gz.sha256"
    recorded = sidecar.read_text().strip()
    tar.unlink()
    payload["bytes"] = b"not the archive that was pinned"
    with pytest.raises(IOError, match="sha256 mismatch"):
        fetch.get_news20(str(src) + os.sep)
    assert not tar.exists()
    payload["bytes"] = good.read_bytes()
    assert fetch.get_news20(str(src) + os.sep) == texts
    assert sidecar.read_text().strip() == recorded


def test_lenet_materializes_mnist_from_a_mirror(tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    _write_idx(mirror, rng, n=16)
    _write_idx(mirror, rng, n=8, prefix="t10k")
    for mod in (fetch, jfetch):
        monkeypatch.setattr(mod, "MNIST_URL", mirror.as_uri() + "/")
    for train in (True, False):
        got = _cli.mnist_arrays(str(tmp_path / "port"), train)
        want = jcli.mnist_arrays(str(tmp_path / "jax"), train)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    model = lenet_train.main(["-f", str(tmp_path / "fresh"), "-b", "8",
                              "-e", "1", "--device", "cpu"])
    assert model is not None
    assert sorted(os.listdir(tmp_path / "fresh")) == sorted(
        os.listdir(mirror))
    monkeypatch.setattr(fetch, "MNIST_URL",
                        (tmp_path / "gone").as_uri() + "/")
    with pytest.raises(SystemExit, match="--synthetic"):
        lenet_train.main(["-f", str(tmp_path / "empty"), "--device",
                          "cpu"])


def test_rnn_materializes_its_corpus_from_a_mirror(tmp_path, monkeypatch,
                                                   capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog .\n" * 30)
    monkeypatch.setattr(fetch, "SHAKESPEARE_URL", corpus.as_uri())
    got = fetch.get_text_corpus(str(tmp_path / "data"))
    assert got.endswith("train.txt") and open(got).read() == \
        corpus.read_text()
    rnn_train.main(["-f", str(tmp_path / "fresh"), "-e", "1", "-b", "4",
                    "--numSteps", "5", "--vocabSize", "20",
                    "--hiddenSize", "8", "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    monkeypatch.setattr(fetch, "SHAKESPEARE_URL",
                        (tmp_path / "gone.txt").as_uri())
    with pytest.raises(SystemExit, match="--synthetic"):
        rnn_train.main(["-f", str(tmp_path / "empty"), "-e", "1",
                        "--device", "cpu"])


def test_the_generator_writes_the_jax_generators_shards(tmp_path):
    rng = np.random.RandomState(0)
    for c in range(3):
        d = tmp_path / "folder" / f"n{c:04d}"
        d.mkdir(parents=True)
        for i in range(4):
            img = rng.randint(0, 256, (5 + i, 7, 3)).astype(np.uint8)
            (d / f"{i}.ppm").write_bytes(
                b"P6\n7 %d\n255\n" % (5 + i) + img.tobytes())
    argv = ["-f", str(tmp_path / "folder"), "-p", "3", "--prefix", "t"]
    got = gen.main(argv + ["-o", str(tmp_path / "port")])
    want = jgen.main(argv + ["-o", str(tmp_path / "jax")])
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()

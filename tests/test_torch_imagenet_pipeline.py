"""The image path of the data plane, the port against the JAX package:
the PPM/BMP decode and the bilinear resize (against Pillow, which the
JAX package decodes and resizes with), JPEG and PNG through Pillow, the
image transformers and the threaded augmenter at one seed, the
``ImageFolderDataSet`` batches at one thread, the exactly-once epoch of
the threaded index stream, the record shards and ``masked_crc32c``, the
ResNet and Inception CLIs from a folder, and three ``LocalOptimizer``
steps over a folder in each package.

Tolerances: pixels, transforms, batches and files bitwise; the training
losses within 1e-5 relative (float32 convolutions summed in other
orders)."""
import io
import os
import sys
import threading

import numpy as np
import pytest
from PIL import Image

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import imagenet as jimagenet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.visualization import crc32c as jcrc
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import image, imagenet
from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.seqfile import write_seq_image_shards
from bigdl_tpu_torch.models.inception import test as inception_test
from bigdl_tpu_torch.models.inception import train as inception_train
from bigdl_tpu_torch.models.resnet import train as resnet_train
from bigdl_tpu_torch.optim import SGD, LocalOptimizer
from bigdl_tpu_torch.utils import crc32c

from _torch_parity import to_jax

FORMATS = ("BMP", "PPM", "PNG", "JPEG")


def _encode(arr, fmt) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt)
    return buf.getvalue()


def _pixels(h, w, seed):
    """Smooth gradients plus noise: both resampling regimes show."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 7 + xx * 3) % 256, (xx * 5) % 256,
                     (yy * 11) % 256], -1)
    return ((base + r.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def _folder(root, classes=3, per=4, seed=0, sizes=((48, 64), (37, 29)),
            formats=("BMP", "PPM")):
    """``root/c<k>/i<j>.<ext>``: sizes and formats in turn."""
    k = 0
    for c in range(classes):
        d = os.path.join(root, f"c{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per):
            h, w = sizes[k % len(sizes)]
            fmt = formats[k % len(formats)]
            ext = {"JPEG": "jpg"}.get(fmt, fmt.lower())
            with open(os.path.join(d, f"i{i}.{ext}"), "wb") as f:
                f.write(_encode(_pixels(h, w, seed + k), fmt))
            k += 1
    return str(root)


# ----------------------------------------------------------- decoding

@pytest.mark.parametrize("fmt", ("BMP", "PPM"))
@pytest.mark.parametrize("hw", ((5, 7), (33, 17), (64, 48), (1, 1)))
def test_ppm_bmp_decode_bitwise_against_jax_pil(fmt, hw):
    data = _encode(_pixels(*hw, seed=3), fmt)
    for scale in (None, 4, 40):
        got = imagenet.decode_image(data, scale=scale)
        want = jimagenet.decode_image(data, scale=scale)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_ppm_comments_and_top_down_bmp_decode_as_pil_does():
    arr = _pixels(4, 6, seed=1)
    ppm = b"P6\n# made here\n6 4\n#x\n255\n" + arr.tobytes()
    np.testing.assert_array_equal(imagenet.decode_image(ppm),
                                  jimagenet.decode_image(ppm))
    bmp = bytearray(_encode(arr, "BMP"))
    offset = int.from_bytes(bmp[10:14], "little")
    stride = ((6 * 24 + 31) >> 3) & ~3
    rows = [bytes(bmp[offset + i * stride:offset + (i + 1) * stride])
            for i in range(4)]
    bmp[offset:offset + 4 * stride] = b"".join(rows[::-1])
    bmp[22:26] = (-4).to_bytes(4, "little", signed=True)
    got = imagenet.decode_image(bytes(bmp))
    np.testing.assert_array_equal(got, jimagenet.decode_image(bytes(bmp)))
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("src,dst", [
    ((375, 500), (341, 256)),    # ImageNet-like shrink
    ((500, 333), (256, 384)),
    ((37, 29), (17, 13)),        # odd sizes
    ((17, 31), (5, 100)),        # shrink one side, enlarge the other
    ((3, 2), (30, 20)),          # enlarge
    ((1, 1), (5, 7)),
    ((64, 48), (48, 64)),        # the unchanged size
    ((90, 90), (1, 1)),
])
def test_resize_bitwise_against_pil(src, dst):
    arr = _pixels(*src, seed=sum(src))
    w, h = (dst[1], dst[0]) if dst == (48, 64) else dst
    want = np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR))
    got = imagenet.resize_bilinear(arr, w, h)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if (w, h) == (arr.shape[1], arr.shape[0]):
        assert got is not arr


@pytest.mark.parametrize("fmt", ("PNG", "JPEG"))
def test_jpeg_png_bitwise_through_pillow(fmt):
    data = _encode(_pixels(45, 61, seed=5), fmt)
    for scale in (None, 24, 80):
        np.testing.assert_array_equal(
            imagenet.decode_image(data, scale=scale),
            jimagenet.decode_image(data, scale=scale))


def test_without_pillow_jpeg_raises_naming_it_and_ppm_still_decodes(
        monkeypatch):
    jpeg = _encode(_pixels(8, 8, 0), "JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        imagenet.decode_image(jpeg)
    arr = _pixels(8, 9, 1)
    ppm = b"P6 9 8 255\n" + arr.tobytes()
    np.testing.assert_array_equal(imagenet.decode_image(ppm), arr)


# ------------------------------------------------------- transformers

def _samples(n=4, seed=0):
    r = np.random.RandomState(seed)
    return [(r.rand(3, 12, 10).astype(np.float32) * 255,
             np.float32(i % 3 + 1)) for i in range(n)]


TRANSFORMS = {
    "normalizer": lambda m: m.ImgNormalizer((10.0, 20.0, 30.0),
                                            (2.0, 3.0, 4.0)),
    "random_crop": lambda m: m.ImgCropper(8, 6, seed=4),
    "padded_crop": lambda m: m.ImgCropper(12, 10, pad=2, seed=5),
    "center_crop": lambda m: m.ImgCropper(8, 6, random=False),
    "hflip": lambda m: m.HFlip(seed=6),
    "color_jitter": lambda m: m.ColorJitter(seed=7),
    "lighting": lambda m: m.Lighting(seed=8),
    "chain": lambda m: m.ImgCropper(8, 8, seed=9) >> m.HFlip(seed=10)
    >> m.ColorJitter(0.3, 0.2, 0.1, seed=11) >> m.Lighting(0.2, seed=12),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transformers_bitwise_at_a_seed(name):
    rows = _samples()
    got = list(TRANSFORMS[name](image)([Sample(x, y) for x, y in rows]))
    want = list(TRANSFORMS[name](jimage)([JaxSample(x, y)
                                          for x, y in rows]))
    assert len(got) == len(want) == len(rows)
    for g, w in zip(got, want):
        assert g.features[0].dtype == np.asarray(w.features[0]).dtype
        np.testing.assert_array_equal(g.features[0], w.features[0])
        np.testing.assert_array_equal(g.labels[0], w.labels[0])


def test_bytes_to_img_and_primitives_bitwise():
    arr = _pixels(6, 5, 2)
    recs = [(arr.tobytes(), 2.0)]
    g = next(iter(image.BytesToImg(6, 5)(recs)))
    w = next(iter(jimage.BytesToImg(6, 5)(recs)))
    np.testing.assert_array_equal(g.features[0], w.features[0])
    chw = np.random.RandomState(0).rand(3, 9, 7).astype(np.float32) * 255
    for seed in range(5):
        np.testing.assert_array_equal(
            image.color_jitter_chw(chw, np.random.RandomState(seed)),
            jimage.color_jitter_chw(chw, np.random.RandomState(seed)))
        np.testing.assert_array_equal(
            image.lighting_chw(chw, np.random.RandomState(seed), scale=255.0),
            jimage.lighting_chw(chw, np.random.RandomState(seed),
                                scale=255.0))
    np.testing.assert_array_equal(image.LIGHTING_EIGVEC,
                                  jimage.LIGHTING_EIGVEC)
    np.testing.assert_array_equal(image.LIGHTING_EIGVAL,
                                  jimage.LIGHTING_EIGVAL)


@pytest.mark.parametrize("train,jitter,lighting", [
    (True, False, False), (True, True, True), (False, True, True)])
def test_augmenter_bitwise(train, jitter, lighting):
    data = _encode(_pixels(40, 52, 9), "BMP")
    args = (24, 32, train, imagenet.IMAGENET_MEAN, imagenet.IMAGENET_STD)
    got_aug = imagenet._Augmenter(*args, color_jitter=jitter,
                                  lighting=lighting)
    want_aug = jimagenet._Augmenter(*args, color_jitter=jitter,
                                    lighting=lighting)
    for seed in range(4):
        got = got_aug(data, np.random.RandomState(seed))
        want = want_aug(data, np.random.RandomState(seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ datasets

def _batches(ds, train, n):
    it = ds.data(train=train)
    try:
        return [next(it) for _ in range(n)] if train else list(it)
    finally:
        ds.close()


def test_image_folder_batches_at_one_thread_bitwise(tmp_path):
    root = _folder(tmp_path / "f")
    kw = dict(batch_size=5, crop=16, scale=20, num_threads=1, prefetch=2,
              seed=3, color_jitter=True, lighting=True)
    got = imagenet.ImageFolderDataSet(root, **kw)
    want = jimagenet.ImageFolderDataSet(root, **kw)
    assert got.classes == want.classes and got.size() == want.size() == 12
    for train in (True, False):
        gb, wb = _batches(got, train, 6), _batches(want, train, 6)
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g.input, np.asarray(w.input))
            np.testing.assert_array_equal(g.target, np.asarray(w.target))


def test_image_folder_process_split_matches_jax(tmp_path):
    root = _folder(tmp_path / "f")
    for index in range(2):
        kw = dict(batch_size=3, crop=16, scale=20, num_threads=1,
                  process_index=index, process_count=2)
        got = imagenet.ImageFolderDataSet(root, **kw)
        want = jimagenet.ImageFolderDataSet(root, **kw)
        assert got.local_size() == want.local_size() == 6
        for g, w in zip(_batches(got, False, 0), _batches(want, False, 0)):
            np.testing.assert_array_equal(g.input, np.asarray(w.input))


@pytest.mark.parametrize("threads", (4, 8))
def test_index_stream_visits_every_item_once_an_epoch(threads):
    n, epochs, k = 37, 6, 3
    stream = imagenet._IndexStream(n, seed=5)
    got = [[] for _ in range(threads)]
    per = n * epochs // (threads * k)
    rest = n * epochs - per * threads * k
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def pull(t):
            for _ in range(per):
                got[t].append(stream.next(k))
        ts = [threading.Thread(target=pull, args=(t,))
              for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    tail = stream.next(rest) if rest else np.zeros(0, np.int64)
    seen = np.concatenate([c for g in got for c in g] + [tail])
    assert np.bincount(seen, minlength=n).tolist() == [epochs] * n
    assert stream.epoch == epochs and stream.pos == 0
    # the permutations themselves are the JAX package's
    jstream = jimagenet._IndexStream(n, seed=5)
    for e in range(3):
        np.testing.assert_array_equal(stream._epoch_perm(e),
                                      jstream._epoch_perm(e))


def test_folder_pool_at_four_threads_yields_the_folders_items(tmp_path):
    """Four workers build batches from one index stream: whichever
    worker takes a chunk, every chunk of the stream's first epochs
    arrives once, items in stream order, so each epoch visits every
    item once. (A later epoch's chunk may arrive before an earlier
    one's: the batches are counted by chunk, not by arrival.)"""
    root = _folder(tmp_path / "f", per=5)
    ds = imagenet.ImageFolderDataSet(root, batch_size=5, num_threads=4)
    paths = [raw for raw, _ in ds._items]
    n, epochs = len(paths), 3
    stream = imagenet._IndexStream(n, seed=1)
    order = np.concatenate([stream._epoch_perm(e) for e in range(epochs)])
    want = [tuple(order[i:i + 5]) for i in range(0, len(order), 5)]
    pool = imagenet._BatchPool(
        ds._items, 5, lambda raw, rng: np.array([paths.index(raw)]),
        num_threads=4, prefetch=2, seed=1)
    got = []
    try:
        while not set(want) <= set(got) and len(got) < 4 * len(want):
            got.append(tuple(pool.next_batch().input[:, 0]))
    finally:
        pool.close()
    assert all(got.count(c) == 1 for c in want), (want, got)
    assert np.bincount(np.concatenate(want)).tolist() == [epochs] * n
    assert not any(t.is_alive() for t in pool.threads)


def test_three_sources_give_equal_batches(tmp_path):
    root = _folder(tmp_path / "f", formats=FORMATS)
    shards = imagenet.write_image_record_shards(root, str(tmp_path / "r"),
                                                num_shards=3)
    seqs = write_seq_image_shards(root, str(tmp_path / "s"), num_shards=2)
    # the shards reorder the items: compare the eval sweep as a set and
    # the train batches over one item order
    kw = dict(batch_size=4, crop=16, scale=20, num_threads=1, seed=2)
    sources = [imagenet.ImageFolderDataSet(root, **kw),
               DataSet.record_shards(shards, **kw),
               imagenet.ImageFolderDataSet(seq_files=seqs, **kw)]

    def keyed(ds):
        out = {}
        for b in _batches(ds, False, 0):
            for x, y in zip(b.input, b.target):
                out[x.tobytes()] = y
        return out

    maps = [keyed(ds) for ds in sources]
    assert maps[0] == maps[1] == maps[2] and len(maps[0]) == 12


# ------------------------------------------------------- record shards

def test_record_shards_byte_identical_and_crc_guarded(tmp_path):
    root = _folder(tmp_path / "f", formats=FORMATS)
    got = imagenet.write_image_record_shards(root, str(tmp_path / "p"),
                                             num_shards=3)
    want = jimagenet.write_image_record_shards(root, str(tmp_path / "j"),
                                               num_shards=3)
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        with open(g, "rb") as a, open(w, "rb") as b:
            assert a.read() == b.read()
    for g, w in zip(got, want):
        assert list(imagenet.read_image_records(w)) == \
            list(jimagenet.read_image_records(g))
    with open(got[0], "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0x01
    bad = str(tmp_path / "bad.btir")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    for reader in (imagenet.read_image_records,
                   jimagenet.read_image_records):
        with pytest.raises(ValueError, match="crc"):
            list(reader(bad))


@pytest.mark.parametrize("n", (0, 1, 9, 1023, 8191, 8192, 8193, 70001))
def test_masked_crc32c_matches_jax(n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    assert crc32c.masked_crc32c(data) == jcrc.masked_crc32c(data)
    assert crc32c.crc32c(data, 77) == jcrc.crc32c(data, 77)
    assert crc32c.unmask(crc32c.masked_crc32c(data)) == jcrc.crc32c(data)


# ------------------------------------------------------------- the CLIs

def _cli_lines(capsys):
    out = capsys.readouterr().out
    loss = [l for l in out.splitlines() if l.startswith("final loss")]
    assert loss and np.isfinite(float(loss[0].split(":")[1]))
    return out


@pytest.mark.parametrize("recipe", ("resnet", "inception"))
def test_cli_trains_from_a_folder_with_validation(recipe, tmp_path, capsys):
    tr = _folder(tmp_path / "train", classes=2, per=3)
    va = _folder(tmp_path / "val", classes=2, per=2, seed=50)
    argv = ["-f", tr, "--valFolder", va, "-b", "3", "--maxIterations",
            "2", "--device", "cpu", "--classNum", "2", "--colorJitter",
            "--lighting"]
    if recipe == "resnet":
        resnet_train.main(argv + ["--dataset", "imagenet"])
    else:
        inception_train.main(argv)
    out = _cli_lines(capsys)
    assert "validation: Top1Accuracy" in out and "Top5Accuracy" in out


def test_inception_test_cli_scores_a_folder(tmp_path, capsys):
    va = _folder(tmp_path / "val", classes=2, per=2, seed=50)
    results = inception_test.main(["-f", va, "-b", "3", "--device", "cpu",
                                   "--classNum", "2"])
    out = capsys.readouterr().out
    assert "Top1Accuracy: Accuracy(" in out and "/4 = " in out
    assert sorted(results) == ["Top1Accuracy", "Top5Accuracy"]


# ------------------------------------------------- training from a folder

def _conv_net(pkg):
    return pkg.Sequential().add(pkg.SpatialConvolution(3, 4, 3, 3, 2, 2)) \
        .add(pkg.ReLU()).add(pkg.Reshape([4 * 7 * 7])) \
        .add(pkg.Linear(4 * 7 * 7, 3)).add(pkg.LogSoftMax())


def _recording_end(trigger_cls, steps, losses):
    """End after ``steps`` iterations, recording each step's loss."""
    def end(state):
        if "Loss" in state:
            losses.append(float(state["Loss"]))
        return state.get("neval", 1) > steps
    return trigger_cls(end, depends_on=frozenset({"neval", "Loss"}))


def test_local_optimizer_over_a_folder_matches_jax(tmp_path):
    from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
    from bigdl_tpu_torch.optim.trigger import Trigger

    root = _folder(tmp_path / "f")
    kw = dict(batch_size=4, crop=16, scale=20, num_threads=1, seed=4,
              color_jitter=True, lighting=True)
    port = _conv_net(nn)
    ref = _conv_net(jnn)
    ref.ensure_initialized()
    ref.set_parameters(to_jax(port.get_parameters()))
    got, want = [], []
    for opt in (
            LocalOptimizer(port, imagenet.ImageFolderDataSet(root, **kw),
                           nn.ClassNLLCriterion(), batch_size=4)
            .set_optim_method(SGD(learning_rate=0.01))
            .set_end_when(_recording_end(Trigger, 3, got)),
            JaxLocalOptimizer(ref, jimagenet.ImageFolderDataSet(root, **kw),
                              jnn.ClassNLLCriterion(), batch_size=4)
            .set_optim_method(JaxSGD(learning_rate=0.01))
            .set_end_when(_recording_end(JaxTrigger, 3, want))):
        try:
            opt.optimize()
        finally:
            opt.dataset.close()
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ("0", "3"):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(
                np.asarray(port.get_parameters()[name][k]),
                np.asarray(ref.get_parameters()[name][k]),
                rtol=1e-4, atol=1e-6)

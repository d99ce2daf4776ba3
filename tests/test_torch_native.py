"""The port's native library (``bigdl_tpu_torch.native``), built here
with g++ from its own sources, against the JAX package's native library
and its Python paths: CRC32C, the idx and CIFAR parsers, both batch
loaders bit for bit (in evaluation mode, and in training mode with one
thread and one seed), ``NativeArrayDataSet``, the errors, and the build
itself (its directory, a failed build, builders racing)."""
import shutil
import threading

import numpy as np
import pytest

from bigdl_tpu import native as jnative
from bigdl_tpu.dataset.native_dataset import \
    NativeArrayDataSet as JaxNativeArrayDataSet
from bigdl_tpu.visualization import crc32c as jcrc
from bigdl_tpu_torch import native, nn
from bigdl_tpu_torch.dataset import NativeArrayDataSet, native_available
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
from bigdl_tpu_torch.utils import crc32c as pcrc


@pytest.fixture(scope="module", autouse=True)
def _built():
    assert native.native_available(), "the port's native library builds"
    assert jnative.native_available()


@pytest.mark.parametrize("size", [0, 9, 1000, 70000])
def test_crc32c_equals_the_jax_native_and_python_crcs(size):
    data = np.random.RandomState(size).bytes(size)
    want = jnative.native_crc32c(data)
    assert native.native_crc32c(data) == want == pcrc.crc32c(data) \
        == jcrc.crc32c(data)
    assert native.native_crc32c(data, 77) == jnative.native_crc32c(data, 77)
    # the masked crc reads the native CRC once it is loaded and checked
    assert pcrc._crc_impl is not pcrc.crc32c
    assert pcrc.masked_crc32c(data) == jcrc.masked_crc32c(data)


def test_parse_idx_and_parse_cifar_equal_jax():
    rng = np.random.RandomState(0)
    body = rng.randint(0, 256, (3, 4, 5)).astype(np.uint8)
    idx = bytes([0, 0, 8, 3]) + b"".join(
        int(d).to_bytes(4, "big") for d in body.shape) + body.tobytes()
    got, want = native.parse_idx(idx), jnative.parse_idx(idx)
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 4, 5)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="code"):
        native.parse_idx(b"\x01\x00\x08\x01")
    cifar = rng.randint(0, 256, 3 * 3073 + 100).astype(np.uint8).tobytes()
    for args in ((cifar,), (cifar, 2)):
        gi, gl = native.parse_cifar(*args)
        wi, wl = jnative.parse_cifar(*args)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def _data(n=20, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, c, 8, 8).astype(np.float32) * 255,
            np.arange(n, dtype=np.float32))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("u8", [False, True])
def test_loaders_equal_jax_bitwise(train, u8):
    imgs, lbls = _data()
    kw = dict(crop=(6, 6), pad=1, train=train, num_threads=1, seed=3)
    if u8:
        imgs = imgs.astype(np.uint8)
        pair = (native.NativeBatchLoaderU8(imgs, lbls, 4, **kw),
                jnative.NativeBatchLoaderU8(imgs, lbls, 4, **kw))
    else:
        kw.update(mean=[1.0, 2.0, 3.0], std=[2.0, 3.0, 4.0])
        pair = (native.NativeBatchLoader(imgs, lbls, 4, **kw),
                jnative.NativeBatchLoader(imgs, lbls, 4, **kw))
    try:
        for _ in range(7):     # past one pass of the rows
            (x, y), (wx, wy) = pair[0].next_batch(), pair[1].next_batch()
            assert x.dtype == wx.dtype
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
    finally:
        for loader in pair:
            loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        pair[0].next_batch()


def test_native_array_dataset_trains_and_sweeps_each_row_once():
    imgs, lbls = _data(n=22)
    labels = 1 + (lbls % 2)
    ds = NativeArrayDataSet(imgs, labels, 4, crop=(6, 6), pad=1, seed=1,
                            num_threads=2)
    try:
        assert native_available() and ds.size() == 22
        rows = np.concatenate([b.target for b in ds.data(train=False)])
        want = JaxNativeArrayDataSet(imgs, labels, 4, crop=(6, 6), pad=1,
                                     seed=1, num_threads=2)
        try:
            wrows = np.concatenate([b.target for b in
                                    want.data(train=False)])
        finally:
            want.close()
        np.testing.assert_array_equal(rows, labels)   # in order, no repeat
        np.testing.assert_array_equal(rows, wrows)
        model = (nn.Sequential().add(nn.Reshape((3 * 6 * 6,)))
                 .add(nn.Linear(3 * 6 * 6, 2)).add(nn.LogSoftMax()))
        opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(),
                             batch_size=4)
        opt.set_optim_method(SGD(learning_rate=0.01))
        opt.set_end_when(max_iteration(6)).optimize()
        assert len(opt.history) == 6
        assert all(np.isfinite(h["loss"]) for h in opt.history)
    finally:
        ds.close()


def test_an_empty_dataset_and_more_than_eight_channels_raise_as_jax():
    imgs, lbls = _data(n=0)
    for cls in (native.NativeBatchLoader, jnative.NativeBatchLoader):
        with pytest.raises(ValueError, match="non-empty"):
            cls(imgs, lbls, 4)
    imgs, lbls = _data(n=4, c=9)
    for cls in (native.NativeBatchLoader, jnative.NativeBatchLoader):
        with pytest.raises(ValueError, match="at most 8"):
            cls(imgs, lbls, 2)
    for cls in (native.NativeBatchLoaderU8, jnative.NativeBatchLoaderU8):
        with pytest.raises(ValueError, match="rejected"):
            cls(imgs.astype(np.uint8), lbls, 2)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src)
    with open(src / "dataloader.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="error"):
        native.build_library()
    assert not native.native_available()
    assert not list((tmp_path / "_build").iterdir())   # no partial file


def test_builders_racing_leave_one_whole_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_library())
        except Exception as e:     # reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "_build").iterdir()] == \
        [paths[0].name]

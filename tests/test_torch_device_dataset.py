"""The port's device cache (``bigdl_tpu_torch.dataset.device_dataset``)
against the JAX package's, on the CPU: the round keys and every visit
order bit for bit, the training and evaluation batches for the same
draws, the shard rotator, and the Optimizer's device-fed paths (per
step, in windows, rotating, validation, resume) against the JAX
Optimizer on a small ResNet. Also: image batches are contiguous NCHW as
fed, staged and cached."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import device_dataset as jdd
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.convert import export_params, export_state
from bigdl_tpu_torch.dataset import device_dataset as pdd
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Top1Accuracy,
                                   every_epoch, max_iteration,
                                   several_iteration)
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import flat, to_jax

#: float32 ResNet-8 through 8 SGD steps with momentum, the port against
#: the JAX package from the same weights and batches: losses relative,
#: every parameter absolute (both packages sum the convolutions in their
#: own orders, and momentum carries the rounding on; the largest gap
#: measured is 4.6e-5, a first convolution's weight on the rotating run,
#: against weights of magnitude 0.1 to 1)
LOSS_RTOL = 1e-4
PARAM_ATOL = 2e-4


def _images(n, c=3, h=8, w=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, c, h, w)).astype(np.uint8),
            (1 + np.arange(n) % 10).astype(np.float32))


# ------------------------------------------------------------ round keys

@pytest.mark.parametrize("seed", [0, 5, 123456])
def test_round_keys_equal_jax_random_bits(seed):
    ds = pdd.DeviceCachedArrayDataSet(*_images(4), 2, shuffle_seed=seed,
                                      device="cpu")
    for epoch in range(4):
        want = np.asarray(jax.random.bits(
            jax.random.fold_in(jax.random.PRNGKey(seed), epoch), (4,),
            jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(ds.round_keys(epoch).numpy(), want)
        key = pdd.fold_in(pdd.prng_key(seed), epoch)
        np.testing.assert_array_equal(
            key.numpy(), np.asarray(jax.random.fold_in(
                jax.random.PRNGKey(seed), epoch)).astype(np.int64))


# -------------------------------------------------------------- indices

@functools.lru_cache(maxsize=None)
def _jax_indices_fn(n, b):
    """JAX's ``sample_indices(epoch=, pos=)`` for one geometry, the key
    an argument (one compile serves every seed), mapped over cursors."""
    ds = jdd.DeviceCachedArrayDataSet(np.zeros((n, 1, 1, 1), np.uint8),
                                      np.zeros(n, np.float32), b)

    def one(key, epoch, pos):
        ds._perm_key = key
        return ds.sample_indices(epoch=epoch, pos=pos)

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0)))


@pytest.mark.parametrize("n", [1, 7, 64, 100, 1000, 4097])
def test_sample_indices_equal_jax_bitwise(n):
    """Every listed cursor: the first batch, the middle, a batch that
    straddles into the next epoch, and a batch larger than n; the direct
    computation, the epoch table and ``step=`` agree with JAX."""
    for b in (3, n + 2):
        fn = _jax_indices_fn(n, b)
        for seed in (0, 5):
            ds = pdd.DeviceCachedArrayDataSet(
                np.zeros((n, 1, 1, 1), np.uint8), np.zeros(n, np.float32),
                b, shuffle_seed=seed, device="cpu")
            cursors = [(e, p) for e in range(4)
                       for p in sorted({0, n // 2, max(0, n - 1)})]
            want = np.asarray(fn(jax.random.PRNGKey(seed),
                                 jnp.asarray([c[0] for c in cursors]),
                                 jnp.asarray([c[1] for c in cursors])))
            for (e, p), w in zip(cursors, want):
                np.testing.assert_array_equal(
                    ds.sample_indices(epoch=e, pos=p).numpy(), w)
                ds.ready_epochs(e)
                np.testing.assert_array_equal(
                    ds.cursor_indices(torch.tensor([e, p])).numpy(), w)
            for step in range(3):
                e, p = divmod(step * b, n)
                np.testing.assert_array_equal(
                    ds.sample_indices(step).numpy(),
                    ds.sample_indices(epoch=e, pos=p).numpy())


def test_each_epoch_visits_every_sample_once():
    n, b = 100, 7
    ds = pdd.DeviceCachedArrayDataSet(*_images(n), b, device="cpu")
    for epoch in range(3):
        ds.ready_epochs(epoch)
        seen = np.concatenate([
            ds.cursor_indices(torch.tensor([epoch, p])).numpy()
            for p in range(0, n, b)])[:n]
        assert sorted(seen) == list(range(n))


def test_the_walk_limit_raises_and_never_truncates():
    ds = pdd.DeviceCachedArrayDataSet(*_images(100), 4, device="cpu")
    ds.walk_limit = 0    # n = 100 walks back from a domain of 256
    with pytest.raises(RuntimeError, match="walk_limit"):
        ds.sample_indices(epoch=0, pos=0)
    with pytest.raises(RuntimeError, match="walk_limit"):
        ds.ready_epochs(0)


# -------------------------------------------------------------- batches

def _jax_draws(jds, rng, epoch, pos):
    """``batch_fn_on``'s draws, split as it splits them."""
    b = jds.batch_size
    _, kyx, kflip = jax.random.split(rng, 3)
    idx = jds.sample_indices(epoch=epoch, pos=pos)
    max_oy = jds.h + 2 * jds.pad - jds.crop_h + 1
    max_ox = jds.w + 2 * jds.pad - jds.crop_w + 1
    oys = jax.random.randint(kyx, (b,), 0, max_oy)
    oxs = jax.random.randint(jax.random.fold_in(kyx, 1), (b,), 0, max_ox)
    flips = jax.random.bernoulli(kflip, 0.5, (b,))
    return [torch.from_numpy(np.array(a)) for a in (idx, oys, oxs, flips)]


@pytest.mark.parametrize("mean,std", [((0.0,) * 3, (1.0,) * 3),
                                      ((125.3, 123.0, 113.9),
                                       (63.0, 62.1, 66.7))])
def test_training_batches_equal_jax_for_jax_draws(mean, std):
    """With JAX's own indices, offsets and flips, the port's batch is
    JAX's bit for bit: at mean 0 / std 1 the float32 batch is the uint8
    crops, so the crops are equal too (tolerance 0)."""
    imgs, lbls = _images(40, h=10, w=12, seed=3)
    kw = dict(crop=(8, 8), pad=2, flip=True, mean=mean, std=std,
              shuffle_seed=4)
    jds = jdd.DeviceCachedArrayDataSet(imgs, lbls, 16, **kw)
    pds = pdd.DeviceCachedArrayDataSet(imgs, lbls, 16, device="cpu", **kw)
    for i, (epoch, pos) in enumerate([(0, 0), (1, 30), (2, 39)]):
        rng = jax.random.PRNGKey(i)
        jx, jy = jds.batch_fn_on(jds.images, jds.labels, rng,
                                 epoch=jnp.int32(epoch), pos=jnp.int32(pos))
        idx, oys, oxs, flips = _jax_draws(jds, rng, epoch, pos)
        x, y = pds.assemble(pds.images, pds.labels, idx, oys, oxs, flips)
        assert x.is_contiguous() and x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        # the port's own draws through the cursor: JAX's indices
        pds.ready_epochs(epoch)
        gen = torch.Generator().manual_seed(i)
        _, py = pds.batch_fn(gen, cursor=torch.tensor([epoch, pos]))
        np.testing.assert_array_equal(py.numpy(), lbls[idx.numpy()])


def test_eval_batches_equal_jax_with_the_wrap():
    imgs, lbls = _images(20, h=10, w=10, seed=5)
    kw = dict(crop=(6, 6), pad=1, mean=(3.0, 4.0, 5.0), std=(2.0, 3.0, 4.0))
    jds = jdd.DeviceCachedArrayDataSet(imgs, lbls, 8, **kw)
    pds = pdd.DeviceCachedArrayDataSet(imgs, lbls, 8, device="cpu", **kw)
    for start in (0, 8, 16):
        jx, jy = jds.eval_batch_fn(start)
        x, y = pds.eval_batch_fn(start)
        assert x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


# -------------------------------------------------------- configuration

def test_the_pad_is_applied_once_and_floats_are_scaled_as_jax():
    imgs, lbls = _images(6, h=5, w=7)
    ds = pdd.DeviceCachedArrayDataSet(imgs, lbls, 2, pad=3, device="cpu")
    assert tuple(ds.images.shape) == (6, 3, 11, 13)
    np.testing.assert_array_equal(
        ds.images.numpy(), np.pad(imgs, ((0, 0), (0, 0), (3, 3), (3, 3))))
    unit = imgs.astype(np.float32) / 255.0
    got = pdd.DeviceCachedArrayDataSet(unit, lbls, 2, device="cpu")
    want = jdd.DeviceCachedArrayDataSet(unit, lbls, 2)
    np.testing.assert_array_equal(got.images.numpy(),
                                  np.asarray(want.images))
    staged = pdd.DeviceCachedArrayDataSet(imgs, lbls, 2, pad=3,
                                          put_chunk_bytes=700,
                                          device="cpu")
    assert torch.equal(staged.images, ds.images)


def test_bad_configurations_raise_as_jax():
    imgs, lbls = _images(4)
    for make in (jdd.DeviceCachedArrayDataSet,
                 functools.partial(pdd.DeviceCachedArrayDataSet,
                                   device="cpu")):
        with pytest.raises(ValueError, match="crop larger"):
            make(imgs, lbls, 2, crop=(9, 9))
        with pytest.raises(ValueError, match="labels shorter"):
            make(imgs, lbls[:3], 2)
    ds = pdd.DeviceCachedArrayDataSet(imgs, lbls, 2, device="cpu")
    with pytest.raises(ValueError, match="together"):
        ds.batch_fn(None, epoch=0)
    with pytest.raises(ValueError, match="BOTH"):
        ds.sample_indices()
    with pytest.raises(NotImplementedError, match="item 11"):
        pdd.DeviceCachedArrayDataSet(imgs, lbls, 2, sharding=object(),
                                     device="cpu")


def test_the_card_is_the_default_and_raises_without_cuda(monkeypatch):
    from bigdl_tpu_torch.utils.transfer import probe_device_put_chunk

    if torch.cuda.is_available():
        pytest.skip("this test checks the raise on a machine without a "
                    "card")
    imgs, lbls = _images(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdd.DeviceCachedArrayDataSet(imgs, lbls, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdd.ShardRotator(lambda i: (imgs, lbls), 2, 2, chunk_bytes=64)
    monkeypatch.delenv("BENCH_CHUNK_MB", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_device_put_chunk()


def test_the_transfer_probe_times_host_copies_and_honours_the_env(
        monkeypatch):
    from bigdl_tpu_torch.utils import transfer

    monkeypatch.setattr(transfer, "_cached_chunk", {})
    monkeypatch.setenv("BENCH_CHUNK_MB", "1.5")
    assert transfer.probe_device_put_chunk(device="cpu") == 3 << 19
    monkeypatch.setattr(transfer, "_cached_chunk", {})
    monkeypatch.delenv("BENCH_CHUNK_MB")
    got = transfer.probe_device_put_chunk(max_mb=8, device="cpu")
    assert got in (4 << 20, 8 << 20)
    assert set(transfer.probe_rates["cpu"]) <= {4 << 20, 8 << 20}
    assert transfer.probe_device_put_chunk(device="cpu") == got  # kept


# ---------------------------------------------------------- ShardRotator

def _provider(i, m=16):
    rng = np.random.RandomState(100 + i)
    return (rng.randint(0, 255, (m, 3, 8, 8)).astype(np.uint8),
            np.full(m, float(i + 1), np.float32))


def _rotator(**kw):
    kw.setdefault("chunk_bytes", 4 * 3 * 8 * 8)     # 4 rows a pump
    kw.setdefault("shuffle_shards", False)
    return pdd.ShardRotator(_provider, 4, 4, crop=(6, 6), device="cpu",
                            **kw)


def test_the_shard_order_is_jax_for_the_same_seed():
    for seed in (0, 7):
        got = _rotator(seed=seed, shuffle_shards=True).order
        want = jdd.ShardRotator(_provider, 4, 4, crop=(6, 6), seed=seed,
                                chunk_bytes=768).order
        np.testing.assert_array_equal(got, want)


def test_pump_is_bounded_and_rotate_swaps_the_slot():
    rot = _rotator()
    first = rot.images
    assert set(rot.labels.tolist()) == {1.0}
    pumps = 1
    while not rot.pump():
        pumps += 1
    assert pumps == 4 and rot.pumped_bytes == 16 * (3 * 64 + 4)
    rot.rotate()
    assert rot.images is not first and rot.resident_slot == 1
    assert set(rot.labels.tolist()) == {2.0}
    imgs, lbls = _provider(1)
    np.testing.assert_array_equal(rot.images.numpy(), imgs)
    while not rot.staged:
        rot.pump()
    rot.rotate()
    # the slots alternate: the first slot again, the third shard in it
    assert rot.images is first and rot.resident_slot == 0
    np.testing.assert_array_equal(rot.images.numpy(), _provider(2)[0])


def test_one_cycle_visits_every_shard_once():
    rot = _rotator()
    seen = []
    for _ in range(4):
        seen.append(float(rot.labels[0]))
        while not rot.staged:
            rot.pump()
        rot.rotate()
    assert sorted(seen) == [1.0, 2.0, 3.0, 4.0]
    assert float(rot.labels[0]) == seen[0] and rot.rotations == 4


def test_rotate_before_staged_and_a_wrong_shard_size_raise():
    rot = _rotator()
    with pytest.raises(RuntimeError, match="pump"):
        rot.rotate()
    with pytest.raises(ValueError, match="shard size mismatch"):
        pdd.ShardRotator(lambda i: _provider(i, m=16 - i), 3, 4,
                         chunk_bytes=768, device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        pdd.ShardRotator(_provider, 1, 4, chunk_bytes=768, device="cpu")


def test_epoch_exact_sampling_within_a_shard():
    tmpl = _rotator().template
    idxs = np.concatenate([tmpl.sample_indices(epoch=0, pos=4 * i).numpy()
                           for i in range(4)])
    assert sorted(idxs) == list(range(16))


# ------------------------------------------------------- the Optimizer

class _Losses:
    """A duck-typed train summary: the JAX Optimizer's per-step losses."""

    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))

    def get_summary_trigger(self, name):
        return None


def _cifar_rows(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8),
            rng.randint(1, 11, n).astype(np.float32))


_GEO = dict(flip=False, mean=(120.0, 118.0, 110.0), std=(60.0, 61.0, 62.0))


def _models():
    tm = ResNet(10, depth=8, dataset="CIFAR10", device="cpu",
                generator=torch.Generator().manual_seed(5))
    jm = JaxResNet(class_num=10, depth=8, dataset="CIFAR10")
    jm.set_parameters(to_jax(export_params(tm)))
    jm.set_state(to_jax(export_state(tm)))
    return tm, jm


def _port_opt(model, ds, steps, k=1):
    RandomGenerator.set_seed(9)
    opt = LocalOptimizer(model, ds, nn.CrossEntropyCriterion(),
                         batch_size=ds.batch_size)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    return opt.set_end_when(max_iteration(steps)).set_steps_per_sync(k)


def _jax_opt(model, ds, steps):
    opt = joptim.LocalOptimizer(model, ds, jnn.CrossEntropyCriterion(),
                                batch_size=ds.batch_size)
    opt.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
    summary = _Losses()
    opt.set_train_summary(summary)
    return opt.set_end_when(joptim.max_iteration(steps)), summary


def _close(got_model, jm, p_losses, j_losses):
    np.testing.assert_allclose(p_losses, j_losses, rtol=LOSS_RTOL)
    g, w = flat(export_params(got_model)), flat(jm.get_parameters())
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_optimizer_on_a_device_cache_matches_jax():
    """ResNet-8 on a 24-image cache, batch 4: 8 steps cross the first
    epoch (a fresh permutation), validation on a cache every epoch; the
    port's losses, parameters and scores against the JAX Optimizer's."""
    imgs, lbls = _cifar_rows(24, 1)
    vimgs, vlbls = _cifar_rows(10, 2)
    tm, jm = _models()
    pds = pdd.DeviceCachedArrayDataSet(imgs, lbls, 4, shuffle_seed=3,
                                       device="cpu", **_GEO)
    jds = jdd.DeviceCachedArrayDataSet(imgs, lbls, 4, shuffle_seed=3,
                                       **_GEO)
    pval = pdd.DeviceCachedArrayDataSet(vimgs, vlbls, 4, device="cpu",
                                        **_GEO)
    jval = jdd.DeviceCachedArrayDataSet(vimgs, vlbls, 4, **_GEO)
    popt = _port_opt(tm, pds, 8)
    popt.set_validation(every_epoch(), pval, [Top1Accuracy()])
    jopt, summary = _jax_opt(jm, jds, 8)
    jopt.set_validation(joptim.every_epoch(), jval,
                        [joptim.Top1Accuracy()])
    popt.optimize()
    jopt.optimize()
    _close(tm, jm, [h["loss"] for h in popt.history], summary.losses)
    assert popt.driver_state["epoch"] == jopt.driver_state["epoch"] == 2
    assert popt.driver_state["score"] == jopt.driver_state["score"]
    # a conflicting batch size raises in both packages
    for opt, val, top1 in ((popt, pval, Top1Accuracy()),
                           (jopt, jval, joptim.Top1Accuracy())):
        with pytest.raises(ValueError, match="batch_size=4"):
            opt.set_validation(every_epoch(), val, [top1], batch_size=8)


def test_optimizer_on_rotating_shards_matches_jax():
    """Three shards of 8 rows, batch 4: 8 steps rotate three times; the
    port's losses and parameters against the JAX Optimizer's."""
    imgs, lbls = _cifar_rows(24, 3)

    def provider(i):
        return imgs[8 * i:8 * i + 8], lbls[8 * i:8 * i + 8]

    tm, jm = _models()
    kw = dict(chunk_bytes=3 * 3 * 32 * 32, seed=2, **_GEO)
    prot = pdd.ShardRotator(provider, 3, 4, device="cpu", **kw)
    jrot = jdd.ShardRotator(provider, 3, 4, **kw)
    popt = _port_opt(tm, pdd.RotatingDeviceDataSet(prot), 8)
    jopt, summary = _jax_opt(jm, jdd.RotatingDeviceDataSet(jrot), 8)
    popt.optimize()
    jopt.optimize()
    assert prot.rotations == 4 and prot.order.tolist() == \
        jrot.order.tolist()
    _close(tm, jm, [h["loss"] for h in popt.history], summary.losses)


def _linear():
    torch.manual_seed(0)
    return (nn.Sequential().add(nn.Reshape((3 * 6 * 6,)))
            .add(nn.Linear(3 * 6 * 6, 4)).add(nn.LogSoftMax()))


def _run(ds, k, steps=14, **kw):
    model = _linear()
    RandomGenerator.set_seed(4)
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(),
                         batch_size=ds.batch_size)
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_end_when(max_iteration(steps)).set_steps_per_sync(k)
    for name, value in kw.items():
        getattr(opt, name)(*value)
    opt.optimize()
    return opt, model


def test_windows_equal_per_step_and_end_at_rollovers_and_shards():
    imgs, lbls = _images(24, h=8, w=8, seed=6)
    lbls = 1 + (lbls - 1) % 4
    ds = pdd.DeviceCachedArrayDataSet(imgs, lbls, 4, crop=(6, 6), pad=1,
                                      device="cpu")
    a, ma = _run(ds, 1)
    b, mb = _run(ds, 4)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert all(torch.equal(p, q) for p, q in zip(ma.parameters(),
                                                 mb.parameters()))
    # 6 steps an epoch: windows of 4, then 2 up to the rollover
    assert {k for k, _ in b.window.shapes} == {4, 2}

    def rotating():
        return pdd.RotatingDeviceDataSet(pdd.ShardRotator(
            lambda i: (imgs[8 * i:8 * i + 8], lbls[8 * i:8 * i + 8]), 3, 4,
            crop=(6, 6), pad=1, chunk_bytes=3 * 3 * 10 * 10, device="cpu"))
    a, ma = _run(rotating(), 1)
    b, mb = _run(rotating(), 4)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert all(torch.equal(p, q) for p, q in zip(ma.parameters(),
                                                 mb.parameters()))
    # two steps a shard: every window ends at a shard boundary, and the
    # two slots have a window each
    assert {k for k, _ in b.window.shapes} == {2}
    assert len(b.window.shapes) == 2


def test_a_resumed_run_visits_the_same_indices(tmp_path):
    """With a full-size crop and no flip a batch is its indices alone: a
    run resumed from its step-6 checkpoint gives the uninterrupted run's
    later losses and final parameters bit for bit."""
    imgs, lbls = _images(24, h=6, w=6, seed=7)
    lbls = 1 + (lbls - 1) % 4

    def cache():
        return pdd.DeviceCachedArrayDataSet(imgs, lbls, 4, flip=False,
                                            device="cpu")
    whole, mw = _run(cache(), 1)
    ck = str(tmp_path / "ck")
    _run(cache(), 1, steps=6,
         set_checkpoint=(ck, several_iteration(7)))
    resumed, mr = _run(cache(), 1, set_checkpoint=(ck, several_iteration(
        100)))
    assert resumed.resumed_from["neval"] == 7
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history][6:]
    assert all(torch.equal(p, q) for p, q in zip(mw.parameters(),
                                                 mr.parameters()))


def test_the_optimizer_raises_on_the_walk_limit():
    ds = pdd.DeviceCachedArrayDataSet(*_images(100, h=6, w=6), 4,
                                      device="cpu")
    ds.walk_limit = 0
    with pytest.raises(RuntimeError, match="walk_limit"):
        _run(ds, 1, steps=2)


# ------------------------------------------------------------ contiguity

def test_fed_staged_and_cached_batches_are_contiguous(tmp_path):
    """The threaded folder feed's batch, the same batch staged, and a
    device cache's training and evaluation batches are contiguous NCHW
    tensors (the layout the card's convolutions take without a
    transpose)."""
    from bigdl_tpu_torch.dataset import ImageFolderDataSet, device_prefetch
    from bigdl_tpu_torch.dataset.sample import minibatch_input_to_device

    rng = np.random.RandomState(0)
    for c in range(2):
        d = tmp_path / f"n{c}"
        d.mkdir()
        for i in range(3):
            img = rng.randint(0, 256, (40 + i, 48, 3)).astype(np.uint8)
            (d / f"{i}.ppm").write_bytes(
                b"P6\n48 %d\n255\n" % (40 + i) + img.tobytes())
    for train in (True, False):
        ds = ImageFolderDataSet(str(tmp_path), batch_size=4, num_threads=2,
                                crop=32, scale=36, seed=1)
        try:
            batch = next(ds.data(train=train))
        finally:
            ds.close()
        fed = minibatch_input_to_device(batch.input, "cpu")
        assert fed.is_contiguous() and fed.shape == (4, 3, 32, 32)
        feed = device_prefetch(iter([batch]), size=1, device="cpu")
        try:
            staged = minibatch_input_to_device(next(feed).input, "cpu")
        finally:
            feed.close()
        assert staged.is_contiguous()
    cache = pdd.DeviceCachedArrayDataSet(*_images(8), 4, crop=(6, 6),
                                         pad=1, device="cpu")
    x, _ = cache.batch_fn(torch.Generator().manual_seed(0))
    assert x.is_contiguous()
    assert cache.eval_batch_fn(6)[0].is_contiguous()

"""The streaming data plane, the port against the JAX package: the
readers' record order and cursors (seeds, epochs, process splits), the
windowed shuffle, the Pipeline's stream and ``state()`` through every
stage, ``as_dataset`` into each package's ``LocalOptimizer`` (an MLP on
an array reader and a packed 2-layer TransformerLM on text shards),
resume at an epoch boundary, the mid-epoch skip, a JAX checkpoint's
cursor resumed in the port, the staged windows of the port's windowed
driver, and the ``datapipe/read`` fault point.

Tolerances: records, cursors and batches bitwise; losses across the
packages within 1e-5 relative (float32, other orders of sums); the
port against itself (resumed, windowed, staged) bitwise."""
import json
import os

import numpy as np
import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu import datapipe as jdp
from bigdl_tpu.dataset.seqfile import SequenceFileWriter
from bigdl_tpu.models import TransformerLM as JaxTransformerLM
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.optim.trigger import several_iteration as jax_several
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import datapipe as dp
from bigdl_tpu_torch import faults, nn, telemetry
from bigdl_tpu_torch.convert import export_params
from bigdl_tpu_torch.dataset.prefetch import StackedWindow
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.dataset.transformer import Lambda
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.optim import SGD, LocalOptimizer
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch,
                                           several_iteration)
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import flat, to_jax

PKGS = {"port": dp, "jax": jdp}
VOCAB, SEQ, ROWS = 40, 16, 4


def _text_shards(root, n_shards=4, docs=9, seed=0):
    """Ragged documents of token ids, one a line."""
    r = np.random.RandomState(seed)
    paths = []
    for s in range(n_shards):
        p = os.path.join(root, f"shard-{s}.txt")
        with open(p, "w") as f:
            for _ in range(docs):
                n = r.randint(1, 2 * SEQ)
                f.write(" ".join(str(t) for t in r.randint(0, VOCAB, n))
                        + "\n")
        paths.append(p)
    return paths


def _ids(line):
    return np.asarray([int(t) for t in line.split()], np.int32)


def _text_pipe(pkg, shards, seed=7, buffer=8, **kw):
    return pkg.Pipeline(pkg.TextLineReader(shards, seed=seed, **kw)) \
        .map(_ids).shuffle(buffer, seed=seed).pack(SEQ, ROWS)


def _flat(item):
    """A record or batch as comparable numpy pieces."""
    if isinstance(item, (list, tuple)):
        return [x for e in item for x in _flat(e)]
    if hasattr(item, "input"):
        return _flat(item.input) + _flat(item.target)
    if hasattr(item, "features"):
        return _flat(item.features) + _flat(item.labels)
    if item is None:
        return []
    return [np.asarray(item)]


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _walk(pipe_or_reader, n, loop=True):
    """``n`` items of the looped stream, each with the cursor after it."""
    it = pipe_or_reader.iterate(loop=loop) if hasattr(
        pipe_or_reader, "iterate") else pipe_or_reader.read(loop=loop)
    out = []
    for _, item in zip(range(n), it):
        out.append((item, pipe_or_reader.state()))
    return out


# ------------------------------------------------------------ readers

@pytest.mark.parametrize("seed", (0, 7, 123))
@pytest.mark.parametrize("split", ((0, 1), (0, 2), (1, 2), (2, 3)))
def test_text_reader_order_and_cursors_match(tmp_path, seed, split):
    shards = _text_shards(str(tmp_path))
    kw = dict(seed=seed, process_index=split[0], process_count=split[1])
    got = _walk(dp.TextLineReader(shards, **kw), 60)
    want = _walk(jdp.TextLineReader(shards, **kw), 60)
    assert [g for g, _ in got] == [w for w, _ in want]
    assert [c for _, c in got] == [c for _, c in want]
    assert {c["epoch"] for _, c in got} >= {0, 1}


def test_array_reader_samples_match_and_restore():
    r = np.random.RandomState(1)
    x, y = r.rand(50, 3).astype(np.float32), r.randint(1, 4, 50)
    kw = dict(shard_size=8, seed=5)
    got = _walk(dp.ArrayRecordReader(x, y, **kw), 120)
    want = _walk(jdp.ArrayRecordReader(x, y, **kw), 120)
    for (g, gc), (w, wc) in zip(got, want):
        _same(g, w)
        assert gc == wc
    assert dp.ArrayRecordReader(x, y, **kw).num_records() == 50
    snap = got[70][1]
    resumed = dp.ArrayRecordReader(x, y, **kw).restore(snap)
    for (g, _), (w, _) in zip(_walk(resumed, 30), want[71:101]):
        _same(g, w)


def test_seqfile_image_reader_matches(tmp_path):
    shards = []
    for s in range(3):
        p = str(tmp_path / f"s{s}.seq")
        with SequenceFileWriter(p) as w:
            for i in range(4):
                w.append(f"n{s}{i}\n{i + 1}".encode(), bytes([s, i]) * 9)
        shards.append(p)
    got = _walk(dp.SeqFileImageReader(shards, seed=2), 30)
    want = _walk(jdp.SeqFileImageReader(shards, seed=2), 30)
    assert got == want


# ------------------------------------------------------------- shuffle

@pytest.mark.parametrize("buffer", (1, 5, 64))
@pytest.mark.parametrize("epoch", (0, 1, 9))
def test_window_shuffle_matches(buffer, epoch):
    records = list(range(40))
    got = list(dp.WindowShuffle(buffer, seed=3)(iter(records), epoch))
    want = list(jdp.WindowShuffle(buffer, seed=3)(iter(records), epoch))
    assert got == want and sorted(got) == records


# ------------------------------------------------------------ pipeline

def _stage_chains():
    def chain(name, pkg, shards):
        if name == "pack":
            return _text_pipe(pkg, shards)
        p = pkg.Pipeline(pkg.TextLineReader(shards, seed=4)).map(_ids) \
            .filter(lambda d: len(d) > 2).shuffle(6, seed=4)
        if name == "bucket":
            return p.bucket([8, SEQ], 3)
        from bigdl_tpu.dataset.sample import Sample as JaxSample
        from bigdl_tpu_torch.dataset.sample import Sample
        cls = Sample if pkg is dp else JaxSample
        return p.map(lambda d: cls(d[:2].astype(np.float32),
                                   np.float32(len(d)))).batch(3)
    return chain


@pytest.mark.parametrize("name", ("pack", "bucket", "batch"))
def test_pipeline_stream_and_state_match(tmp_path, name):
    shards = _text_shards(str(tmp_path))
    chain = _stage_chains()
    got = _walk(chain(name, dp, shards), 40)
    want = _walk(chain(name, jdp, shards), 40)
    for (g, gc), (w, wc) in zip(got, want):
        _same(g, w)
        assert gc == wc
    # resume from a snapshot: both continue alike
    snap = got[17][1]
    g2 = _walk(chain(name, dp, shards).restore(snap), 10)
    w2 = _walk(chain(name, jdp, shards).restore(snap), 10)
    for (g, _), (w, _) in zip(g2, w2):
        _same(g, w)


def test_detached_pass_and_epoch_count_match(tmp_path):
    shards = _text_shards(str(tmp_path))
    pipe, ref = _text_pipe(dp, shards), _text_pipe(jdp, shards)
    assert pipe.count_epoch_records() == ref.count_epoch_records()
    a, b = list(pipe.iterate_detached()), list(ref.iterate_detached())
    assert len(a) == len(b)
    for g, w in zip(a, b):
        _same(g, w)
    assert pipe.state() == {"epoch": 0, "spos": 0, "offset": 0}
    ds = pipe.as_dataset(batch_size=ROWS, device="cpu")
    assert ds.size() == ref.as_dataset(batch_size=ROWS).size()
    assert ds.continuous_stream and ds.batch_size == ROWS


def test_datapipe_read_fault_point_ends_the_iterator_with_the_error(
        tmp_path):
    shards = _text_shards(str(tmp_path), n_shards=1)
    before = telemetry.REGISTRY.counter("faults/point/injected").value(
        point="datapipe/read")
    with faults.armed("datapipe/read=nth:3,raise:OSError"):
        it = _text_pipe(dp, shards, buffer=1).iterate(loop=True)
        with pytest.raises(OSError):
            list(it)
    after = telemetry.REGISTRY.counter("faults/point/injected").value(
        point="datapipe/read")
    assert after == before + 1


# --------------------------------------------------- training through it

def _samples_pipe(pkg, seed=5, n=96, batch=16):
    r = np.random.RandomState(41)
    x = r.randn(n, 8).astype(np.float32)
    y = (np.arange(n) % 3 + 1).astype(np.float32)
    return pkg.Pipeline(pkg.ArrayRecordReader(x, y, shard_size=24,
                                              seed=seed)) \
        .shuffle(32, seed=seed).batch(batch, drop_remainder=True)


def _mlp(pkg):
    return pkg.Sequential().add(pkg.Linear(8, 16)).add(pkg.Tanh()) \
        .add(pkg.Linear(16, 3)).add(pkg.LogSoftMax())


def _recording_end(cls, steps, losses):
    """End after iteration ``steps``; each step's loss appended (the
    first call, before any step of this run, records nothing)."""
    last = []

    def end(state):
        if last and state["neval"] != last[-1]:
            losses.append(float(state["Loss"]))
        last.append(state["neval"])
        return state.get("neval", 1) > steps
    return cls(end, depends_on=frozenset({"neval"}))


def _port_run(ds, model, steps, ckpt=None, trigger=None, k=1):
    losses = []
    opt = LocalOptimizer(model, ds, _criterion(model), batch_size=16)
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_end_when(_recording_end(Trigger, steps, losses))
    if ckpt:
        opt.set_checkpoint(ckpt, trigger)
    if k > 1:
        # the recording end trigger is not plannable: windows need a
        # plain one
        from bigdl_tpu_torch.optim import max_iteration
        opt.set_end_when(max_iteration(steps))
        opt.set_steps_per_sync(k)
    opt.optimize()
    if k > 1:
        losses = [h["loss"] for h in opt.history]
    return losses, opt


def _jax_run(ds, model, steps, ckpt=None, trigger=None):
    losses = []
    opt = JaxLocalOptimizer(model, ds, _criterion(model), batch_size=16)
    opt.set_optim_method(JaxSGD(learning_rate=0.1))
    opt.set_end_when(_recording_end(JaxTrigger, steps, losses))
    if ckpt:
        opt.set_checkpoint(ckpt, trigger)
    opt.optimize()
    return losses, opt


def _criterion(model):
    lm = isinstance(model, (TransformerLM, JaxTransformerLM))
    pkg = nn if isinstance(model, nn.Module) else jnn
    if lm:
        return pkg.SequenceCrossEntropyCriterion(ignore_index=-1)
    return pkg.ClassNLLCriterion()


def _pair_mlp():
    port = _mlp(nn)
    ref = _mlp(jnn)
    ref.ensure_initialized()
    ref.set_parameters(to_jax(port.get_parameters()))
    return port, ref


def _pair_lm():
    port = TransformerLM(VOCAB, hidden_size=16, num_layers=2, num_heads=2,
                         max_len=SEQ, device="cpu",
                         generator=__import__("torch").Generator()
                         .manual_seed(3))
    JaxRandomGenerator.set_seed(3)
    ref = JaxTransformerLM(VOCAB, hidden_size=16, num_layers=2, num_heads=2,
                           max_len=SEQ)
    ref.ensure_initialized()
    ref.set_parameters(to_jax(export_params(port)))
    return port, ref


def _cursor(ck):
    """The datapipe cursor of the newest checkpoint under ``ck``."""
    from bigdl_tpu_torch.utils.serialization import find_latest_checkpoint
    with open(os.path.join(find_latest_checkpoint(ck),
                           "host_state.json")) as f:
        return json.load(f)["driver_state"]["datapipe"]


def _params(model):
    """``{name: numpy}`` of either package's parameters."""
    if isinstance(model, nn.Module):
        return flat(export_params(model))
    return flat(model.get_parameters())


def _same_params(a, b, **tol):
    assert sorted(a) == sorted(b)
    for k in a:
        if tol:
            np.testing.assert_allclose(a[k], b[k], **tol)
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("source", ("samples", "packed_text"))
def test_as_dataset_training_matches_jax(tmp_path, source):
    if source == "samples":
        port, ref = _pair_mlp()
        pd, jd = _samples_pipe(dp), _samples_pipe(jdp)
        steps = 8
    else:
        shards = _text_shards(str(tmp_path))
        port, ref = _pair_lm()
        pd, jd = _text_pipe(dp, shards), _text_pipe(jdp, shards)
        steps = 6
    got, _ = _port_run(pd.as_dataset(device="cpu"), port, steps)
    want, _ = _jax_run(jd.as_dataset(), ref, steps)
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_resume_at_an_epoch_boundary_is_bitwise(tmp_path):
    """96 rows in batches of 16: an epoch is 6 steps. A run of 6 steps
    checkpointed at its epoch's end, resumed for 6 more, equals 12 steps
    straight."""
    torch = pytest.importorskip("torch")
    ck = str(tmp_path / "ck")
    straight = _mlp(nn)
    start = [p.detach().clone() for p in straight.parameters()]
    want, _ = _port_run(_samples_pipe(dp).as_dataset(device="cpu"),
                        straight, 12)
    first = _mlp(nn)
    with torch.no_grad():
        for p, s in zip(first.parameters(), start):
            p.copy_(s)
    _port_run(_samples_pipe(dp).as_dataset(device="cpu"), first, 6, ck,
              every_epoch())
    cursor = _cursor(ck)
    assert cursor == {"epoch": 1, "spos": 0, "offset": 0}
    ds = _samples_pipe(dp).as_dataset(device="cpu")
    resumed, opt = _port_run(ds, _mlp(nn), 12, ck, every_epoch())
    assert opt.resumed_from["neval"] == 7
    assert "datapipe" not in opt.driver_state
    np.testing.assert_array_equal(resumed, want[6:])
    _same_params(_params(opt.model), _params(straight))


def test_mid_epoch_resume_skips_what_the_jax_package_skips(tmp_path):
    """A checkpoint after step 3 holds the reader's cursor, which ran
    ahead through the shuffle buffer: both packages resume there and
    skip the same records."""
    results = {}
    pair = dict(zip(("port", "jax"), _pair_mlp()))
    for name in ("port", "jax"):
        model = pair[name]
        pkg = PKGS[name]
        ck = str(tmp_path / name)
        run = _port_run if name == "port" else _jax_run
        trig = several_iteration(3) if name == "port" else jax_several(3)
        ds = _samples_pipe(pkg).as_dataset(
            **({"device": "cpu"} if name == "port" else {}))
        run(ds, model, 3, ck, trig)
        cursor = _cursor(ck)
        fresh = _mlp(nn) if name == "port" else _mlp(jnn)
        if name == "jax":
            fresh.ensure_initialized()
        ds = _samples_pipe(pkg).as_dataset(
            **({"device": "cpu"} if name == "port" else {}))
        losses, opt = run(ds, fresh, 8, ck, trig)
        results[name] = (cursor, losses, _params(opt.model))
    assert results["port"][0] == results["jax"][0]
    cursor = results["port"][0]
    # the reader ran ahead of the trainer by the 32-record buffer at least
    assert cursor["epoch"] == 0 and cursor["spos"] * 24 + cursor["offset"] \
        >= 32 + 16
    np.testing.assert_allclose(results["port"][1], results["jax"][1],
                               rtol=1e-5)
    _same_params(results["port"][2], results["jax"][2], rtol=1e-5,
                 atol=1e-6)


def test_a_jax_checkpoints_cursor_resumes_in_the_port(tmp_path):
    ck = str(tmp_path / "ck")
    port, ref = _pair_mlp()
    _jax_run(_samples_pipe(jdp).as_dataset(), ref, 4, ck, jax_several(4))
    cursor = _cursor(ck)
    want, _ = _jax_run(_samples_pipe(jdp).as_dataset(), _mlp(jnn), 9, ck,
                       jax_several(100))
    seen = []
    ds = _samples_pipe(dp).as_dataset(device="cpu")
    real = ds.restore_pipeline_state
    ds.restore_pipeline_state = lambda s: (seen.append(dict(s)), real(s))
    got, opt = _port_run(ds, port, 9, ck, several_iteration(100))
    assert seen == [cursor]
    assert opt.resumed_from["path"].endswith(
        f"checkpoint.{opt.resumed_from['neval']}")
    assert len(got) == 9 - opt.resumed_from["neval"] + 1
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_transformed_pipeline_dataset_still_checkpoints_the_cursor(
        tmp_path):
    ck = str(tmp_path / "ck")
    ds = _samples_pipe(dp).as_dataset(device="cpu").transform(
        Lambda(lambda mb: mb))
    assert ds.continuous_stream
    _port_run(ds, _mlp(nn), 3, ck, several_iteration(3))
    assert _cursor(ck)["offset"] > 0


def _staged_run(k, staged_k, steps=14):
    RandomGenerator.set_seed(17)
    model = _mlp(nn)
    with __import__("torch").no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(__import__("torch").from_numpy(
                np.random.RandomState(i).rand(*p.shape).astype(np.float32)
                - 0.5))
    ds = _samples_pipe(dp).as_dataset(batch_size=16, staged_k=staged_k,
                                      device="cpu")
    losses, opt = _port_run(ds, model, steps, k=k)
    return losses, _params(model), opt


@pytest.mark.parametrize("k,staged_k", ((1, 4), (4, 4), (4, 3), (3, 8)))
def test_staged_windows_equal_the_per_step_run(k, staged_k):
    """Windows staged by ``stage_windows`` (on the CPU: stacked host
    arrays) run as their steps: per step, or cut to the driver's
    windows, which end at epoch boundaries (6 steps an epoch)."""
    want_losses, want_params, _ = _staged_run(1, None)
    if k > 1:
        want_losses = [h["loss"] for h in _staged_run(1, None)[2].history]
    got_losses, got_params, opt = _staged_run(k, staged_k)
    assert len(got_losses) == 14
    np.testing.assert_array_equal(got_losses, want_losses)
    _same_params(got_params, want_params)
    assert opt.driver_state["epoch"] == 3
    assert opt.driver_state["recordsProcessedThisEpoch"] == 2 * 16


def test_stage_windows_marks_windows_and_their_rows():
    pipe = _samples_pipe(dp)
    it = pipe.staged(k=4, loop=True, device="cpu")
    try:
        w = next(it)
    finally:
        it.close()
    assert isinstance(w, StackedWindow)
    assert w.input.shape == (4, 16, 8) and w.size() == 64
    rows = w.split()
    assert [r.index for r in rows] == [0, 1, 2, 3]
    np.testing.assert_array_equal(rows[2].input, w.input[2])
    part = w.rows(1, 3)
    assert part.steps() == 2 and isinstance(part, MiniBatch)

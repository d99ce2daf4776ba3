"""The port's windowed driver (``Optimizer.set_steps_per_sync``) against
its own per-step loop and against the JAX package's windowed driver
(``tests/test_windowed.py``'s driver cases): K steps a host sync must be
observably the per-step loop.

On the CPU a window runs its K steps one by one (the CUDA graph is the
card's), so equality with the per-step loop is bitwise here: same
losses, parameters, counters, trigger firings and checkpoint names.
Against the JAX package (float32, the same seeded weights and shuffles)
losses and parameters agree within 1e-5 and trigger steps exactly.
"""
import logging
import os

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.dataset import prefetch as jprefetch
from bigdl_tpu.dataset.sample import MiniBatch as JaxMiniBatch
from bigdl_tpu.optim.optim_method import Plateau as JaxPlateau
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch import precision as prec
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, Sample
from bigdl_tpu_torch.dataset import SampleToMiniBatch
from bigdl_tpu_torch.dataset import prefetch
from bigdl_tpu_torch.optim.optimizer import _window_stackable
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.random import RandomGenerator

ATOL = 1e-5
_PKG = {"jax": (jnn, joptim, JaxDataSet, JaxSample, JaxSampleToMiniBatch,
                JaxRandomGenerator, JaxTrigger),
        "port": (nn, optim, DataSet, Sample, SampleToMiniBatch,
                 RandomGenerator, Trigger)}


# ---------------------------------------------------------------- helpers

def _toy_xy(n=96, d=8, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d).astype(np.float32) * 3
    x = np.stack([centers[i % classes]
                  + rng.randn(d).astype(np.float32) * 0.5
                  for i in range(n)])
    y = np.array([i % classes + 1 for i in range(n)], np.float32)
    return x, y


_WEIGHTS = {}


def _weights():
    """The JAX test's MLP (8 -> 16 -> tanh -> 3, LogSoftMax) weights,
    seeded once, carried into both packages."""
    if not _WEIGHTS:
        JaxRandomGenerator.set_seed(1)
        m = _mlp("jax")
        m.ensure_initialized()
        _WEIGHTS["p"] = jax.tree.map(np.asarray, m.get_parameters())
    return _WEIGHTS["p"]


def _mlp(pkg):
    n = _PKG[pkg][0]
    if pkg == "jax":
        return n.Sequential().add(n.Linear(8, 16)).add(n.Tanh()) \
            .add(n.Linear(16, 3)).add(n.LogSoftMax())
    return n.Sequential(n.Linear(8, 16), n.Tanh(), n.Linear(16, 3),
                        n.LogSoftMax())


def _ds(pkg, n=96, batch=32, seed=0):
    _, _, ds, sample, smb, _, _ = _PKG[pkg]
    x, y = _toy_xy(n, seed=seed)
    return ds.array([sample(x[i], y[i]) for i in range(n)]) \
        .transform(smb(batch))


def _opt(pkg, k, iters=12, seed=11, lr=0.1, n=96, batch=32,
         opt_batch=None, end_when=None):
    nn_, o, *_, rg, _ = _PKG[pkg]
    weights = _weights()    # seeds the JAX generator the first time
    rg.set_seed(seed)
    model = _mlp(pkg)
    model.set_parameters(weights if pkg == "port" else
                         jax.tree.map(np.asarray, weights))
    opt = o.LocalOptimizer(model, _ds(pkg, n, batch), nn_.ClassNLLCriterion(),
                           batch_size=opt_batch or batch)
    opt.set_optim_method(o.SGD(learning_rate=lr))
    opt.set_end_when(end_when or o.max_iteration(iters))
    opt.set_steps_per_sync(k)
    return opt


def _params(model):
    return [np.asarray(a) for _, a in sorted(
        _flat(model.get_parameters()).items())]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = np.asarray(v)
    return out


# ---------------------------------------------- K=1 vs K>1 equivalence

_REFERENCE = {}


def _jax_reference():
    if not _REFERENCE:
        opt = _opt("jax", 8)
        model = opt.optimize()
        _REFERENCE["v"] = (opt.driver_state["Loss"], _params(model),
                           opt.driver_state["epoch"])
    return _REFERENCE["v"]


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_windowed_matches_per_step_and_jax(k):
    """12 steps, 3 batches an epoch (windows end at every rollover): K
    steps a sync equal the per-step run bitwise (losses, parameters,
    counters) and the JAX package's K=8 run within 1e-5."""
    base = _opt("port", 1)
    base.optimize()
    opt = _opt("port", k)
    model = opt.optimize()
    assert [h["loss"] for h in opt.history] == \
        [h["loss"] for h in base.history]
    assert [h["neval"] for h in opt.history] == list(range(1, 13))
    for a, b in zip(_params(model), _params(base.model)):
        np.testing.assert_array_equal(a, b)
    for key in ("neval", "epoch", "recordsProcessedThisEpoch"):
        assert opt.driver_state[key] == base.driver_state[key]
    loss, params, epoch = _jax_reference()
    assert opt.driver_state["epoch"] == epoch
    np.testing.assert_allclose(opt.driver_state["Loss"], loss, atol=ATOL)
    for a, b in zip(_params(model), params):
        np.testing.assert_allclose(a, b, atol=ATOL)
    if k > 1:
        # windows of min(k, 3) steps (3 batches an epoch), one shape
        assert opt.window.shapes and len(opt.window.shapes) <= 2
        assert opt.window.captures == 0     # no graph on the CPU


def test_f16_windowed_scaler_backs_off_inside_a_window_bitwise():
    """f16_mixed with ``DynamicLossScaler(init_scale=2**24,
    growth_interval=4)``: the first step of the first window overflows
    and is skipped; K=8 equals K=1 bitwise (losses, parameters, the
    scale and the skipped count), the twin of the JAX package's K=1 vs
    K=8 carry test."""
    from bigdl_tpu_torch import telemetry
    runs = []
    for k in (1, 8):
        opt = _opt("port", k, n=256, iters=8)
        opt.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
        opt.set_precision("f16_mixed", prec.DynamicLossScaler(
            init_scale=2.0 ** 24, growth_interval=4))
        model = opt.optimize()
        runs.append(([h["loss"] for h in opt.history], _params(model),
                     telemetry.gauge("train/precision/loss_scale").value(),
                     telemetry.gauge("train/precision/skipped_steps")
                     .value()))
        assert all(p.dtype == torch.float32 for p in model.parameters())
    (l1, p1, s1, k1), (l8, p8, s8, k8) = runs
    assert l1 == l8 and (s1, k1) == (s8, k8)
    assert k1 >= 1 and s1 < 2.0 ** 24
    for a, b in zip(p1, p8):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- window planning

@pytest.mark.parametrize("case", [
    # (k, neval, records, bsz, ds_size, end, validation, checkpoint)
    (8, 1, 0, 8, 10 ** 6, 100, 3, None),
    (8, 3, 0, 8, 10 ** 6, 100, 3, None),
    (8, 1, 0, 8, 10 ** 6, 100, None, 5),
    (8, 1, 0, 8, 10 ** 6, 6, None, None),
    (4, 1, 0, 8, 10 ** 6, 100, None, None),
    (8, 1, 0, 32, 96, 100, None, None),
    (8, 2, 40, 32, 96, 100, None, 4)])
def test_plan_window_flushes_as_jax(case):
    """Validation, checkpoint and end boundaries and the epoch rollover
    end a window at the step the JAX planner ends it."""
    k, neval, rec, bsz, ds_size, end, val, ck = case
    got = []
    for pkg in ("jax", "port"):
        o = _PKG[pkg][1]
        opt = _opt(pkg, k)
        opt.validation_trigger = val and o.several_iteration(val)
        opt.checkpoint_trigger = ck and o.several_iteration(ck)
        st = {"epoch": 1, "neval": neval, "recordsProcessedThisEpoch": rec}
        got.append(opt._plan_window(k, st, bsz, ds_size,
                                    o.max_iteration(end)))
    assert got[0] == got[1]


def test_every_epoch_peek_does_not_mutate():
    for o in (joptim, optim):
        t = o.every_epoch()
        assert not t.peek({"epoch": 2})     # nothing latched yet
        assert not t({"epoch": 1})          # latches the baseline
        assert t.peek({"epoch": 2}) and t.peek({"epoch": 2})
        assert t({"epoch": 2})
        assert not t({"epoch": 2})


def test_trigger_metadata_matches_jax():
    for o, trig in ((joptim, JaxTrigger), (optim, Trigger)):
        assert o.several_iteration(5).depends_on == {"neval"}
        assert o.min_loss(0.1).depends_on == {"Loss"}
        assert o.max_score(0.9).depends_on == {"score"}
        assert not o.min_loss(0.1).plannable()
        assert o.several_iteration(5).plannable()
        assert o.max_epoch(2).plannable() and o.max_iteration(2).plannable()
        both = o.several_iteration(5).or_(o.every_epoch())
        assert both.depends_on == {"neval", "epoch"} and both.plannable()
        assert o.several_iteration(5).and_(o.max_epoch(3)).depends_on == \
            {"neval", "epoch"}
        unknown = trig(lambda s: False)
        assert unknown.depends_on is None and not unknown.plannable()
        assert o.several_iteration(5).and_(unknown).depends_on is None
    from bigdl_tpu.optim.trigger import PLANNABLE_KEYS as JAX_KEYS
    from bigdl_tpu_torch.optim.trigger import PLANNABLE_KEYS
    assert PLANNABLE_KEYS == JAX_KEYS


# ----------------------------------------------------- per-step fallback

class _MetricSchedule(optim.LearningRateSchedule):
    """A schedule that reads the validation score (what Plateau does in
    the JAX package; the port has no Plateau yet)."""

    def update(self, o):
        return o.learning_rate

    def record_metric(self, value):
        pass


@pytest.mark.parametrize("case", ["loss trigger", "unknown trigger",
                                  "metric schedule"])
def test_fallbacks_carry_the_jax_reason(case, caplog):
    """The same configuration falls back to per-step in both packages
    with the same reason text, and the port logs it and still trains."""
    whys = {}
    for pkg in ("jax", "port"):
        o, trig = _PKG[pkg][1], _PKG[pkg][6]
        opt = _opt(pkg, 8, iters=4)
        end = o.max_iteration(4)
        if case == "loss trigger":
            end = o.min_loss(0.01).or_(o.max_iteration(4))
        elif case == "unknown trigger":
            opt.validation_trigger = trig(lambda s: s["neval"] % 7 == 0)
        else:
            opt.set_optim_method(o.SGD(
                learning_rate=0.1, learning_rate_schedule=JaxPlateau()
                if pkg == "jax" else _MetricSchedule()))
        args = (8, end, False) if pkg == "jax" else (8, end)
        k, why = opt._window_limit(*args)
        assert k == 1
        whys[pkg] = why
        if pkg == "port":
            opt.set_end_when(end)
            with caplog.at_level(logging.INFO,
                                 "bigdl_tpu_torch.optim.optimizer"):
                opt.optimize()
            assert opt.window is None
            assert opt.driver_state["neval"] == 5
            assert any(why in r.getMessage() for r in caplog.records)
    assert whys["jax"] == whys["port"]


def test_device_resident_batches_are_not_stackable():
    """A leaf already on a device (here torch's ``meta`` device) keeps the
    per-step path, as a device array does in the JAX package; host
    arrays and CPU tensors stack."""
    x = np.zeros((2, 3), np.float32)
    assert _window_stackable(MiniBatch(x, x))
    assert _window_stackable(MiniBatch([torch.zeros(2, 3), x], None))
    assert not _window_stackable(MiniBatch(torch.zeros(2, 3,
                                                       device="meta"), x))
    assert not _window_stackable(MiniBatch(
        [x, torch.zeros(2, device="meta")], x))


# --------------------------------------- boundary-equivalence end-to-end

def _spied_validate(opt, calls):
    orig = opt._validate

    def spy(*a):
        calls.append(opt.driver_state["neval"])
        return orig(*a)

    opt._validate = spy


def test_validation_fires_at_the_jax_steps_with_its_scores():
    """Validation every 3 iterations over 9: the port at K=1 and K=8 and
    the JAX package at K=8 validate after steps 3, 6 and 9, with scores
    within 1e-5."""
    rows = {}
    for pkg, k in (("jax", 8), ("port", 1), ("port", 8)):
        nn_, o = _PKG[pkg][:2]
        opt = _opt(pkg, k, iters=9, seed=17)
        opt.set_validation(o.several_iteration(3), _ds(pkg, seed=1),
                           [o.Loss(nn_.ClassNLLCriterion())])
        calls = []
        _spied_validate(opt, calls)
        opt.optimize()
        rows[(pkg, k)] = (calls, opt.driver_state["score"])
    assert rows[("jax", 8)][0] == rows[("port", 1)][0] == \
        rows[("port", 8)][0] == [3, 6, 9]
    assert rows[("port", 1)][1] == rows[("port", 8)][1]
    np.testing.assert_allclose(rows[("port", 8)][1], rows[("jax", 8)][1],
                               atol=ATOL)


def test_actual_batch_sizes_guard_trigger_boundaries():
    """The Optimizer is told batch 32 while the dataset yields 64 rows:
    the planner under-counts records, so the gather re-peeks the triggers
    with the actual sizes and a records trigger fires at the per-step
    loop's step, in both packages."""
    rows = {}
    for pkg, k in (("jax", 8), ("port", 1), ("port", 8)):
        nn_, o, *_, trig = _PKG[pkg]
        opt = _opt(pkg, k, iters=4, seed=37, n=192, batch=64, opt_batch=32)
        opt.set_validation(
            trig(lambda s: s.get("recordsProcessedThisEpoch", 0) >= 64,
                 depends_on=frozenset({"recordsProcessedThisEpoch"})),
            _ds(pkg, seed=1), [o.Loss(nn_.ClassNLLCriterion())])
        calls = []
        _spied_validate(opt, calls)
        opt.optimize()
        rows[(pkg, k)] = calls
    assert rows[("jax", 8)] == rows[("port", 1)] == rows[("port", 8)]
    assert rows[("port", 1)]


def test_checkpoints_written_at_the_jax_steps(tmp_path):
    dirs = {}
    for pkg, k in (("jax", 8), ("port", 1), ("port", 8)):
        o = _PKG[pkg][1]
        path = str(tmp_path / f"{pkg}{k}")
        opt = _opt(pkg, k, iters=8, seed=19)
        opt.set_checkpoint(path, o.several_iteration(4))
        opt.optimize()
        dirs[(pkg, k)] = sorted(os.listdir(path))
    assert dirs[("jax", 8)] == dirs[("port", 1)] == dirs[("port", 8)] == \
        ["checkpoint.4", "checkpoint.8"]


# -------------------------------------------------------- window stacking

def _mb(mod, i, b=4, d=3):
    return mod(np.full((b, d), i, np.float32), np.full((b,), i, np.float32))


def test_stack_windows_groups_tails_and_shape_changes_as_jax():
    def shapes(stream):
        return [(w.input.shape, w.target.shape) for w in stream]

    for batches in ([0, 1, 2, 3, 4], [0, 1, 2]):
        got = shapes(prefetch.stack_windows(
            iter([_mb(MiniBatch, i) for i in batches]), 2))
        want = shapes(jprefetch.stack_windows(
            iter([_mb(JaxMiniBatch, i) for i in batches]), 2))
        assert got == want
    mixed = [_mb(MiniBatch, 0), _mb(MiniBatch, 1, b=2), _mb(MiniBatch, 2)]
    jmixed = [_mb(JaxMiniBatch, 0), _mb(JaxMiniBatch, 1, b=2),
              _mb(JaxMiniBatch, 2)]
    assert shapes(prefetch.stack_windows(iter(mixed), 4)) == \
        shapes(jprefetch.stack_windows(iter(jmixed), 4))
    with pytest.raises(ValueError, match="window size"):
        next(prefetch.stack_windows(iter(mixed), 0))


def test_stack_minibatches_and_signature_match_jax():
    planes = [MiniBatch([np.full((2, 5), i, np.int32),
                         np.full((2, 5), -i, np.int32)],
                        np.full((2, 5), i, np.int64)) for i in range(3)]
    jplanes = [JaxMiniBatch(list(b.input), b.target) for b in planes]
    got = prefetch.stack_minibatches(planes)
    want = jprefetch.stack_minibatches(jplanes)
    for g, w in zip(got.input + [got.target], want.input + [want.target]):
        np.testing.assert_array_equal(g, w)
    assert prefetch.batch_signature(planes[0]) == \
        jprefetch.batch_signature(jplanes[0])
    t = MiniBatch(torch.zeros(2, 3), None)
    assert prefetch.batch_signature(t) == jprefetch.batch_signature(
        JaxMiniBatch(np.zeros((2, 3), np.float32), None))
    for mod, bmod in ((prefetch, MiniBatch), (jprefetch, JaxMiniBatch)):
        for order in ((None, np.ones(2)), (np.ones(2), None)):
            with pytest.raises(ValueError, match="mix None"):
                mod.stack_minibatches([bmod(np.ones((2, 1)), t_)
                                       for t_ in order])


# ------------------------------------------------------------------- CLI

def test_steps_per_sync_flag_in_the_lenet_recipe(capsys):
    """``--steps-per-sync 4`` in ``models.lenet.train`` on the CPU trains
    the same steps as the per-step recipe, with windows."""
    from bigdl_tpu_torch.models.lenet import train as lenet_train
    argv = ["--synthetic", "48", "-b", "16", "--maxIterations", "5",
            "--device", "cpu"]
    finals = []
    for extra in ([], ["--steps-per-sync", "4"]):
        RandomGenerator.set_seed(3)       # the same shuffles both times
        lenet_train.main(argv + extra)
        out = capsys.readouterr().out
        finals.append([line for line in out.splitlines()
                       if line.startswith("final loss")])
    assert finals[0] and finals[0] == finals[1]
    with pytest.raises(ValueError, match="steps_per_sync must be >= 1"):
        lenet_train.main(argv + ["--steps-per-sync", "0"])

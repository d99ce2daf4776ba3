"""Retry from checkpoint, the port against the JAX package: the port's
own copy of the classified retry policy (``bigdl_tpu_torch.faults.retry``)
agrees with ``bigdl_tpu.faults.retry`` on every exception type and on
every backoff delay under one seed, ``retry_call`` counts and fails as
the JAX package's does, and ``Optimizer.optimize()`` retries a
transient failure from the newest checkpoint, fails fast on a fatal one
and re-raises where there is no checkpoint path; each failure is
injected through the ``train/step`` fault point.

Tolerance: none — classes, delays and counters are equal, and a run
retried from a checkpoint at an epoch boundary is bitwise the
uninterrupted run (the same steps on the same data from the same
state, on the CPU)."""
import random

import numpy as np
import pytest
import torch

from bigdl_tpu.faults import retry as jretry
from bigdl_tpu.utils.serialization import CheckpointCorrupt as JaxCorrupt
from bigdl_tpu_torch import faults, nn, optim, telemetry
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.serialization import CheckpointCorrupt

_RECOVERIES = telemetry.counter("train/optimizer/recoveries")


class _Unknown(Exception):
    pass


@pytest.mark.parametrize("exc", [
    TypeError("x"), ValueError("shape"), KeyError("k"), IndexError("i"),
    AttributeError("a"), NotImplementedError(), ImportError("m"),
    SyntaxError("s"), MemoryError(), OSError("io"), FileNotFoundError("f"),
    ConnectionError("c"), TimeoutError("t"), RuntimeError("CUDA error"),
    Exception("unknown"), _Unknown()], ids=lambda e: type(e).__name__)
def test_classify_agrees_with_the_jax_package(exc):
    assert faults.classify(exc) == jretry.classify(exc)
    assert faults.is_transient(exc) == jretry.is_transient(exc)


def test_a_corrupt_checkpoint_escaping_resume_is_fatal_in_both():
    assert faults.classify(CheckpointCorrupt("digest")) == \
        jretry.classify(JaxCorrupt("digest")) == "fatal"


@pytest.mark.parametrize("base,cap", [(1.0, 8.0), (0.05, 30.0), (3.0, 3.0)])
def test_backoff_delays_equal_the_jax_packages_under_one_seed(base, cap):
    got = [faults.backoff_delay(a, base, cap, random.Random(7))
           for a in range(8)]
    want = [jretry.backoff_delay(a, base, cap, random.Random(7))
            for a in range(8)]
    assert got == want
    rng = random.Random(3)
    for a in range(8):
        full = min(base * 2 ** a, cap)
        assert full / 2 <= faults.backoff_delay(a, base, cap, rng) <= full


def test_retry_call_retries_transient_counts_and_fails_fast():
    counter = telemetry.counter("io/retry/retries")
    before = counter.value()
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    assert faults.retry_call(flaky, attempts=4, base_delay_s=0.01,
                             sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    assert counter.value() - before == 2

    broken = []

    def fatal():
        broken.append(1)
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        faults.retry_call(fatal, attempts=5, sleep=lambda s: None)
    assert len(broken) == 1

    with pytest.raises(OSError):
        faults.retry_call(lambda: (_ for _ in ()).throw(OSError("down")),
                          attempts=2, sleep=lambda s: None)
    with pytest.raises(ValueError):
        faults.retry_call(flaky, attempts=0)


# ------------------------------------------------------ optimize() retry
# Failures are injected through the ``train/step`` fault point, as the
# JAX package's retry tests inject them: ``nth:6`` fires before step 6.


def _lenet_like():
    return nn.Sequential(nn.Linear(12, 16), nn.Tanh(), nn.Linear(16, 4),
                         nn.LogSoftMax())


def _run(tmp_path, checkpoint=True, steps=12):
    """A 12-step run of a small classifier from seeded weights and
    data, 3 batches of 8 an epoch and a checkpoint every 4 iterations:
    ``checkpoint.4`` is written after step 3, at the first epoch's end
    (a resume replays the epoch it lands in from its start, in both
    packages, so only a checkpoint at an epoch's start resumes exactly
    the uninterrupted run's data)."""
    RandomGenerator.set_seed(3)
    r = np.random.RandomState(0)
    x = r.randn(24, 12).astype(np.float32)
    y = (np.arange(24) % 4 + 1).astype(np.float32)
    model = _lenet_like()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape) * 0.3)
    data = DataSet.array([Sample(x[i], y[i]) for i in range(24)]) \
        .transform(SampleToMiniBatch(8))
    opt = optim.LocalOptimizer(model, data, nn.ClassNLLCriterion(),
                               batch_size=8)
    opt.set_optim_method(optim.Adam(learning_rate=1e-2))
    opt.set_end_when(optim.max_iteration(steps))
    if checkpoint:
        opt.set_checkpoint(str(tmp_path), optim.several_iteration(4))
    opt.retry_interval_s = 1e-3
    return opt


def test_a_transient_failure_resumes_from_the_newest_checkpoint(tmp_path):
    """An ``OSError`` before step 6: one recovery, the run resumed from
    ``checkpoint.4`` (Adam's ``t`` with it), and the final parameters,
    the losses and ``t`` are bitwise the uninterrupted run's."""
    straight = _run(tmp_path / "a")
    straight.optimize()
    before = _RECOVERIES.value()
    retried = _run(tmp_path / "b")
    with faults.armed("train/step=nth:6,raise:OSError") as sched:
        retried.optimize()
    assert sched.fired() == {"train/step": 1}
    assert _RECOVERIES.value() - before == 1
    assert retried.resumed_from["path"].endswith("checkpoint.4")
    assert [h["neval"] for h in retried.history] == list(range(1, 13))
    assert [h["loss"] for h in retried.history] == \
        [h["loss"] for h in straight.history]
    assert all(torch.equal(a, b) for a, b in zip(
        retried.model.parameters(), straight.model.parameters()))
    assert int(retried.train_step.opt_state["t"]) == 12


def test_a_fatal_failure_raises_at_once(tmp_path):
    before = _RECOVERIES.value()
    opt = _run(tmp_path)
    with faults.armed("train/step=nth:6,raise:TypeError"):
        with pytest.raises(TypeError, match="injected fault"):
            opt.optimize()
    assert _RECOVERIES.value() == before
    assert opt.driver_state["neval"] == 6


def test_without_a_checkpoint_path_the_failure_raises(tmp_path):
    before = _RECOVERIES.value()
    opt = _run(tmp_path, checkpoint=False)
    with faults.armed("train/step=nth:6,raise:OSError"):
        with pytest.raises(OSError, match="injected fault"):
            opt.optimize()
    assert _RECOVERIES.value() == before


def test_retries_stop_after_retry_times(tmp_path):
    """A failure on every attempt: ``retry_times`` recoveries, then the
    error itself."""
    before = _RECOVERIES.value()
    opt = _run(tmp_path)
    opt.retry_times = 2
    with faults.armed("train/step=raise:RuntimeError") as sched:
        with pytest.raises(RuntimeError, match="injected fault"):
            opt.optimize()
    assert _RECOVERIES.value() - before == 2
    assert sched.fired() == {"train/step": 3}


def test_retry_settings_come_from_the_jax_packages_variables(monkeypatch):
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_TIMES", "3")
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_INTERVAL", "0.25")
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_MAX_INTERVAL", "2")
    opt = optim.LocalOptimizer(_lenet_like(), None, nn.ClassNLLCriterion())
    assert (opt.retry_times, opt.retry_interval_s,
            opt.retry_max_interval_s) == (3, 0.25, 2.0)
    monkeypatch.delenv("BIGDL_FAILURE_RETRY_TIMES")
    assert optim.LocalOptimizer(_lenet_like(), None,
                                nn.ClassNLLCriterion()).retry_times == 5

"""Fault injection, the port against the JAX package: the port's copy of
``faults.core`` (``bigdl_tpu_torch.faults``) fires on the same calls as
``bigdl_tpu.faults`` for the same schedule string and the same call
sequence (``nth``, ``prob`` with a seed, ``match``, ``times``, sibling
rules), rejects the same malformed schedules, and carries the JAX
package's ``KNOWN_POINTS`` whole; every point the port places is in it,
and each placed point fails its site the way the site's recovery
expects: the decode loop restarts after ``serving/decode``, the batcher
after ``serving/take_batch``, the breaker counts ``serving/dispatch``,
a ``serving/swap`` leaves the old version current, and a
``ckpt/write_manifest`` fault publishes no checkpoint.

Tolerance: none — call numbers, counts and types are equal."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu import faults as jfaults
from bigdl_tpu_torch import faults, nn, telemetry
from bigdl_tpu_torch.generation import GenerationConfig, GenerationService
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import (InferenceService, ModelRegistry,
                                     ServingConfig, WorkerDied)
from bigdl_tpu_torch.utils.serialization import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]

SCHEDULES = [
    "p/x=nth:3,raise:RuntimeError",
    "p/x=nth:2-5,raise:OSError",
    "p/x=prob:0.3,seed:7,raise:ValueError",
    "p/x=prob:0.5,seed:11,times:4,raise",
    "p/x=match:kind=b,nth:2,raise:TypeError",
    "p/x=match:step=4,raise:ConnectionError",
    "p/x=nth:2,raise:OSError;p/x=nth:2-4,raise:TimeoutError",
    "p/x=prob:0.25,seed:3,raise;p/x=nth:5,times:1,raise:IOError",
    "p/x=delay:0,nth:4;p/x=nth:4-6,raise",
]


def _fires(mod, schedule, calls=60):
    """``[(call index, exception type name)]`` for ``calls`` calls of
    the point with a cycling context, under ``schedule``."""
    out = []
    with mod.armed(schedule) as sched:
        for i in range(calls):
            try:
                mod.point("p/x", kind="abc"[i % 3], step=i)
            except Exception as e:  # noqa: BLE001 — the injected fault
                out.append((i, type(e).__name__))
        fired = sched.fired()
    return out, fired


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_fire_on_the_same_calls_as_the_jax_package(schedule):
    got, got_fired = _fires(faults, schedule)
    want, want_fired = _fires(jfaults, schedule)
    assert got == want
    assert got_fired == want_fired
    assert faults.injected_total() == jfaults.injected_total()


@pytest.mark.parametrize("bad", ["", "p/x", "p/x=", "p/x=nth:1,zap",
                                 "p/x=raise:NoSuchError", "p/x=sigkill:1,zz"])
def test_malformed_schedules_are_refused_as_in_the_jax_package(bad):
    with pytest.raises(ValueError):
        jfaults.parse_schedule(bad)
    with pytest.raises(ValueError):
        faults.parse_schedule(bad)


def test_points_are_noops_when_disarmed_and_count_when_fired():
    faults.disarm()
    faults.point("serving/decode", model="m")  # disarmed: nothing
    counter = telemetry.counter("faults/point/injected")
    before = counter.value(point="fleet/route")
    with faults.armed("fleet/route=nth:1-2,raise") as sched:
        for _ in range(2):
            with pytest.raises(faults.InjectedFault):
                faults.point("fleet/route", session="")
        faults.point("fleet/route", session="")
    assert counter.value(point="fleet/route") - before == 2
    assert sched.fired() == {"fleet/route": 2}
    assert not faults.is_armed() and faults.active_schedule() is sched
    assert faults.classify(faults.InjectedFault("x")) == "transient"


def test_known_points_are_the_jax_packages_and_cover_every_placed_point():
    assert faults.KNOWN_POINTS == jfaults.KNOWN_POINTS
    assert faults.NAMED_EXCEPTIONS.keys() == jfaults.NAMED_EXCEPTIONS.keys()
    placed = set()
    for path in (ROOT / "bigdl_tpu_torch").rglob("*.py"):
        placed |= set(re.findall(r'faults\.point\(\s*"([^"]+)"',
                                 path.read_text()))
    assert placed == {"serving/dispatch", "serving/take_batch",
                      "serving/swap", "serving/decode", "train/step",
                      "ckpt/write_manifest", "fleet/route",
                      "fleet/replica", "fleet/verify", "prefetch/stage",
                      "datapipe/read", "fetch/download"}
    assert placed <= set(faults.KNOWN_POINTS)


# ---------------------------------------------------------- the sites

def _lm():
    return TransformerLM(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=4, max_len=32, device="cpu",
                         generator=torch.Generator().manual_seed(1)).eval()


def test_a_decode_fault_fails_live_streams_typed_and_the_loop_restarts():
    svc = GenerationService(config=GenerationConfig(
        slots=2, max_len=32, length_buckets=(32,), prefill_rows=2),
        device="cpu")
    try:
        svc.load("lm", _lm())
        want = svc.generate("lm", [3, 7, 1], max_new_tokens=6).result(60)
        with faults.armed("serving/decode=nth:3,raise:RuntimeError") as s:
            stream = svc.generate("lm", [3, 7, 1], max_new_tokens=6)
            with pytest.raises(WorkerDied, match="injected fault"):
                stream.result(60)
        assert s.total_fired() == 1
        again = svc.generate("lm", [3, 7, 1], max_new_tokens=6).result(60)
        assert np.array_equal(again, want)
        assert svc.metrics("lm")["worker_restarts"] == 1
    finally:
        svc.shutdown()


def _mlp():
    g = torch.Generator().manual_seed(0)
    return nn.Sequential(nn.Linear(4, 8, generator=g), nn.ReLU(),
                         nn.Linear(8, 3, generator=g)).eval()


def test_dispatch_and_take_batch_faults_fail_typed_and_serving_goes_on():
    svc = InferenceService(config=ServingConfig(max_batch_size=4,
                                                max_wait_ms=1.0),
                           device="cpu")
    x = np.ones((1, 4), np.float32)
    try:
        svc.load("m", _mlp())
        want = svc.predict("m", x)
        with faults.armed("serving/dispatch=nth:1,raise:OSError"):
            with pytest.raises(OSError, match="injected fault"):
                svc.predict("m", x)
        assert svc._breakers["m"]._consecutive == 1
        with faults.armed("serving/take_batch=nth:1,raise:RuntimeError"):
            with pytest.raises(WorkerDied):
                svc.predict("m", x)
        np.testing.assert_array_equal(svc.predict("m", x), want)
    finally:
        svc.shutdown()


def test_a_swap_fault_leaves_the_old_version_current():
    reg = ModelRegistry()
    reg.load("m", _mlp())
    reg.load("m", _mlp(), activate=False)
    with faults.armed("serving/swap=match:version=2,raise:RuntimeError"):
        with pytest.raises(RuntimeError, match="injected fault"):
            reg.swap("m", 2)
    assert reg.current("m").version == 1
    assert reg.swap("m", 2).version == 2


def test_a_manifest_fault_publishes_no_checkpoint(tmp_path):
    path = tmp_path / "checkpoint.4"
    kw = dict(params={"w": np.ones(3, np.float32)}, opt_state={},
              model_state={}, optim_host_state={},
              driver_state={"neval": 4})
    with faults.armed("ckpt/write_manifest=match:neval=4,raise:OSError"):
        with pytest.raises(OSError, match="injected fault"):
            save_checkpoint(str(path), **kw)
    assert not path.exists()
    save_checkpoint(str(path), **kw)
    assert (path / "MANIFEST.json").is_file()

"""``device_prefetch``, the port against the JAX package, on the CPU
(where the port stages nothing and passes the batches through): order
and content, the close protocol that joins the stager, an upstream error
raised in the consumer and not taken for the end of the data, the
``prefetch/stage`` fault point, the four instruments under the JAX
package's names, and ``"cuda"`` without a card. The copy to the card
itself (pinned ring, side stream, events) runs in chip_smoke.py's phase
20. Everything exact."""
import threading
import time

import numpy as np
import pytest
import torch

import bigdl_tpu.telemetry as jtelemetry
from bigdl_tpu.dataset.prefetch import device_prefetch as jax_prefetch
from bigdl_tpu.dataset.sample import MiniBatch as JaxMiniBatch
from bigdl_tpu_torch import faults, telemetry
from bigdl_tpu_torch.dataset.prefetch import device_prefetch
from bigdl_tpu_torch.dataset.sample import MiniBatch

INSTRUMENTS = {"data/prefetch/queue_depth": "gauge",
               "data/prefetch/stage_s": "histogram",
               "data/prefetch/fetch_wait_s": "histogram",
               "data/prefetch/staged_batches": "counter"}


def _batches(n, cls=MiniBatch, seed=0):
    r = np.random.RandomState(seed)
    return [cls([r.rand(4, 3).astype(np.float32),
                 r.randint(0, 9, (4, 2)).astype(np.int32)],
                r.rand(4).astype(np.float32)) for _ in range(n)]


def _stagers():
    return [t for t in threading.enumerate() if t.name == "device_prefetch"]


def _wait_gone(timeout=5.0):
    deadline = time.time() + timeout
    while _stagers() and time.time() < deadline:
        time.sleep(0.02)
    return not _stagers()


@pytest.mark.parametrize("size", (1, 2, 5))
def test_order_and_content_pass_through_as_the_jax_package_stages(size):
    got = list(device_prefetch(iter(_batches(7)), size=size, device="cpu"))
    want = list(jax_prefetch(iter(_batches(7, JaxMiniBatch)), size=size))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        for a, b in zip(g.input + [g.target], list(w.input) + [w.target]):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert _wait_gone()


def test_close_joins_the_stager():
    assert _wait_gone()
    it = device_prefetch(iter(_batches(50)), size=2, device="cpu")
    next(it)
    time.sleep(0.2)            # the stager parks on the full queue
    assert len(_stagers()) == 1
    it.close()
    assert _wait_gone(2.0), "the stager outlived close()"


def test_an_upstream_error_is_raised_in_the_consumer():
    def upstream():
        yield from _batches(3)
        raise OSError("shard vanished")

    it = device_prefetch(upstream(), size=2, device="cpu")
    got = [next(it) for _ in range(3)]
    assert len(got) == 3
    with pytest.raises(OSError, match="shard vanished"):
        next(it)
    assert _wait_gone()


def test_the_prefetch_stage_fault_point():
    counter = telemetry.REGISTRY.counter("faults/point/injected")
    before = counter.value(point="prefetch/stage")
    with faults.armed("prefetch/stage=nth:2,raise"):
        it = device_prefetch(iter(_batches(6)), size=2, device="cpu")
        first = next(it)
        with pytest.raises(faults.InjectedFault):
            next(it)
        it.close()
    assert isinstance(first, MiniBatch)
    assert counter.value(point="prefetch/stage") == before + 1
    assert _wait_gone()


def test_the_four_instruments_keep_the_jax_names():
    import bigdl_tpu.dataset.prefetch  # noqa: F401  (registers JAX's)
    for name, kind in INSTRUMENTS.items():
        # a name asked for as another kind than it was registered raises
        assert getattr(telemetry, kind)(name).name == name
        assert getattr(jtelemetry, kind)(name).name == name
    staged = telemetry.counter("data/prefetch/staged_batches")
    stage_s = telemetry.histogram("data/prefetch/stage_s")
    wait_s = telemetry.histogram("data/prefetch/fetch_wait_s")
    depth = telemetry.gauge("data/prefetch/queue_depth")
    n0, s0, w0 = staged.total(), stage_s.count(), wait_s.count()
    out = list(device_prefetch(iter(_batches(5)), size=3, device="cpu"))
    assert len(out) == 5
    assert staged.total() == n0 + 5
    assert stage_s.count() == s0 + 5 and wait_s.count() == w0 + 5
    assert all(v >= 0 for v in stage_s.samples() + wait_s.samples())
    assert 0 <= depth.value() <= 3


def test_cuda_without_a_card_raises_at_the_call():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the copy runs in chip_smoke.py")
    with pytest.raises(RuntimeError, match="card"):
        device_prefetch(iter(_batches(1)), device="cuda")

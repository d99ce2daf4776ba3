"""The port's InferenceService on the CPU: micro-batched ``predict`` /
``predict_batch`` against the direct forward at every rung, the
one-program-per-rung bound, calibrated and gated int8 loads (a refused
candidate stages nothing), hot-swap, typed admission errors, the circuit
breaker, and a calibrated int8 servable answering bitwise like the JAX
package's.

Tolerances: an int8 model's rows are bitwise the direct forward of the
same rows alone (its integer products are exact and everything else is
per element, so the padded batch a row rides in cannot move it); a
float model's rows within 1e-6 (its float matrix product may sum in
another order at another batch size)."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.serving import InferenceService as JaxService
from bigdl_tpu.serving import ServingConfig as JaxConfig
from bigdl_tpu.utils.random import RandomGenerator
from bigdl_tpu_torch import nn, telemetry
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.nn.quantized import QuantizedLinear
from bigdl_tpu_torch.precision import AccuracyGate, AccuracyGateError
from bigdl_tpu_torch.serving import (BucketLadder, DeadlineExceeded, Degraded,
                                     InferenceService, MicroBatcher,
                                     QueueFull, ServingConfig)

FLOAT_ATOL = 1e-6


def _mlp(seed=0, din=12, dout=5):
    g = torch.Generator().manual_seed(seed)
    return nn.Sequential(nn.Linear(din, 32, generator=g), nn.ReLU(),
                         nn.Linear(32, dout, generator=g)).eval()


def _rows(seed, n, din=12, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((n, din))
            * scale).astype(np.float32)


def _service(**kw):
    return InferenceService(config=ServingConfig(**kw), device="cpu")


def _direct(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_predict_and_predict_batch_equal_the_direct_forward_at_each_rung():
    model = _mlp()
    svc = _service(max_batch_size=8, max_wait_ms=1.0)
    try:
        svc.load("f32", model)
        q = svc.load("int8", model, quantize=True,
                     calibration=[_rows(1, 16), _rows(2, 16)])
        assert isinstance(q.model[0], QuantizedLinear)
        x = _rows(3, 8)
        for n in range(1, 9):                  # rungs 1, 2, 4, 8 + padding
            got_q = svc.predict_batch("int8", x[:n])
            got_f = svc.predict_batch("f32", x[:n])
            for i in range(n):
                np.testing.assert_array_equal(
                    got_q[i], _direct(q.model, x[i:i + 1])[0])
            np.testing.assert_allclose(got_f, _direct(model, x[:n]),
                                       rtol=0, atol=FLOAT_ATOL)
        for i in range(3):
            np.testing.assert_array_equal(svc.predict("int8", x[i]),
                                          _direct(q.model, x[i:i + 1])[0])
        assert svc.compile_count("int8") <= len(svc.ladder)
        m = svc.metrics("int8")
        assert m["request_count"] == 8 + 3 and m["errors"] == 0
        assert 0 < m["batch_fill"] <= 1 and "latency_ms_p99" in m
    finally:
        svc.shutdown()


def test_program_bound_and_warmup():
    model = _mlp(seed=1)
    svc = _service(max_batch_size=16, max_wait_ms=2.0)
    try:
        svc.load("m", model, warmup_shape=(12,))
        assert svc.compile_count("m") == len(svc.ladder) == 5
        assert svc.warmup("m", (12,)) == 0          # every rung built
        r = np.random.default_rng(4)
        futs = [svc.predict_batch_async("m", _rows(i, int(r.integers(1, 17))))
                for i in range(40)]
        for f in futs:
            assert np.isfinite(f.result(timeout=60)).all()
        assert svc.compile_count("m") == len(svc.ladder)
        assert svc.metrics("m")["batch_count"] <= 40
    finally:
        svc.shutdown()


def test_dispatch_thread_runs_in_inference_mode():
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append((torch.is_inference_mode_enabled(),
                         threading.current_thread().name))
            return x * 2

    svc = _service(max_batch_size=4)
    try:
        svc.load("p", Probe().eval())
        out = svc.predict("p", np.ones(3, np.float32))
        np.testing.assert_array_equal(out, np.full(3, 2.0, np.float32))
    finally:
        svc.shutdown()
    assert seen == [(True, "serving-batcher-p")]
    assert not torch.is_inference_mode_enabled()


def test_gated_load_passes_and_refused_load_stages_nothing():
    model = _mlp(seed=2)
    svc = _service(max_batch_size=8)
    try:
        honest = svc.load(
            "q", model, quantize=True,
            calibration=[_rows(5, 16), _rows(6, 16)],
            accuracy_gate=AccuracyGate(_rows(7, 64), max_delta=0.02),
            warmup_shape=(12,))
        delta = telemetry.gauge("serving/precision/accuracy_delta") \
            .value(model="q")
        assert 0.0 <= delta <= 0.02
        programs = svc.compile_count("q")
        x = _rows(8, 3)
        before = svc.predict_batch("q", x)
        with pytest.raises(AccuracyGateError, match="exceeds the gate"):
            svc.load("q", model, quantize=True,
                     calibration=[_rows(5, 16, scale=1e-4)],
                     accuracy_gate=AccuracyGate(_rows(7, 64, scale=50.0),
                                                max_delta=0.02),
                     warmup_shape=(12,))
        assert svc.registry.versions("q") == [honest.version]
        assert svc.registry.current("q") is honest
        assert svc.compile_count("q") == programs
        np.testing.assert_array_equal(svc.predict_batch("q", x), before)
        with pytest.raises(ValueError, match="quantize=True"):
            svc.load("q", model, calibration=[_rows(5, 4)])
    finally:
        svc.shutdown()


def test_hot_swap_and_unload():
    svc = _service(max_batch_size=4, max_wait_ms=1.0)
    x = np.ones((2, 3), np.float32)
    try:
        v1 = svc.load("c", nn.Sequential(nn.MulConstant(1.0)).eval())
        np.testing.assert_array_equal(svc.predict_batch("c", x), x)
        v2 = svc.load("c", nn.Sequential(nn.MulConstant(2.0)).eval(),
                      warmup_shape=(3,))
        np.testing.assert_array_equal(svc.predict_batch("c", x), 2 * x)
        svc.swap("c", v1.version)
        np.testing.assert_array_equal(svc.predict_batch("c", x), x)
        with pytest.raises(ValueError, match="current servable"):
            svc.unload("c", v1.version)
        programs = svc.compile_count("c", v2.version)
        assert programs == len(svc.ladder)
        svc.unload("c", v2.version)
        assert svc.cache.compile_count(v2.key) == 0
        assert svc.registry.versions("c") == [v1.version]
    finally:
        svc.shutdown()


class _Gate(torch.nn.Module):
    """A forward that blocks until released (a busy card)."""

    def __init__(self):
        super().__init__()
        self.entered = threading.Event()
        self.release = threading.Event()

    def forward(self, x):
        self.entered.set()
        self.release.wait(timeout=30)
        return x


def test_service_queue_full_and_deadline_exceeded():
    gate = _Gate().eval()
    svc = _service(max_batch_size=1, max_queue=1, max_wait_ms=1.0)
    x = np.zeros(2, np.float32)
    try:
        svc.load("slow", gate)
        f1 = svc.predict_async("slow", x)
        assert gate.entered.wait(timeout=10)
        deadline = time.monotonic() + 10
        while svc.metrics("slow")["queue_depth"] and \
                time.monotonic() < deadline:
            time.sleep(0.001)
        f2 = svc.predict_async("slow", x, timeout_ms=30.0)   # fills it
        with pytest.raises(QueueFull):
            svc.predict_async("slow", x)
        time.sleep(0.1)             # f2's deadline passes while busy
        gate.release.set()
        np.testing.assert_array_equal(f1.result(timeout=10), x)
        with pytest.raises(DeadlineExceeded):
            f2.result(timeout=10)
        m = svc.metrics("slow")
        assert m["rejected"] == 1 and m["timed_out"] == 1
    finally:
        gate.release.set()
        svc.shutdown()


def test_batcher_deadline_and_queue_full():
    release, entered = threading.Event(), threading.Event()

    def slow_run(x):
        entered.set()
        release.wait(timeout=30)
        return x

    b = MicroBatcher(slow_run, BucketLadder(4), max_wait_ms=1.0,
                     max_queue=1, name="full")
    try:
        f1 = b.submit(np.zeros((1, 2), np.float32))
        assert entered.wait(timeout=10)
        deadline = time.monotonic() + 10
        while b.queue_depth() and time.monotonic() < deadline:
            time.sleep(0.001)
        f2 = b.submit(np.zeros((1, 2), np.float32), timeout_ms=30.0)
        with pytest.raises(QueueFull):
            b.submit(np.zeros((1, 2), np.float32))
        time.sleep(0.1)
        release.set()
        assert f1.result(timeout=10).shape == (1, 2)
        with pytest.raises(DeadlineExceeded):
            f2.result(timeout=10)
        assert b.stats.rejected == 1 and b.stats.timed_out == 1
        with pytest.raises(ValueError, match="exceeds max_batch_size"):
            b.submit(np.zeros((5, 2), np.float32))
    finally:
        release.set()
        b.shutdown()


def test_breaker_sheds_after_failures():
    class Broken(torch.nn.Module):
        def forward(self, x):
            raise RuntimeError("broken weights")

    svc = _service(max_batch_size=2, breaker_failures=2,
                   breaker_cooldown_ms=60_000)
    try:
        svc.load("b", Broken().eval())
        for _ in range(2):
            with pytest.raises(RuntimeError, match="broken weights"):
                svc.predict("b", np.zeros(2, np.float32))
        assert svc.breaker_state("b") == "open"
        with pytest.raises(Degraded):
            svc.predict("b", np.zeros(2, np.float32))
        assert svc.metrics("b")["shed"] == 1
    finally:
        svc.shutdown()


def test_load_checks():
    svc = _service()
    try:
        with pytest.raises(ValueError, match="training mode"):
            svc.load("t", _mlp().train())
        with pytest.raises(ValueError, match="model is on"):
            svc.load("m", _mlp().to("meta"))
        with pytest.raises(NotImplementedError):
            svc.load("p", path="/nonexistent")
        with pytest.raises(NotImplementedError):
            svc.registry.load("s", _mlp(), input_spec=(12,))
        with pytest.raises(KeyError):
            svc.predict("missing", np.zeros(3, np.float32))
    finally:
        svc.shutdown()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceService()


@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_servable_answers_like_the_jax_package(with_bias):
    """One calibrated QuantizedLinear served by both packages: the same
    quantized weights and scale, exact integer products, the same
    epilogue order — bitwise equal rows without a bias. With a bias,
    XLA's jit of the JAX service contracts ``acc * xs * ws + bias`` into
    one fused multiply-add (the effect the JAX package's int8_gemm note
    records on the TPU); the port's eager multiply and add round twice,
    as the JAX package's own eager path does, so a row differs by at
    most one rounding of the product, 1e-6 at these magnitudes (well
    over one ulp of a result that cancels against its bias)."""
    RandomGenerator.set_seed(3)
    jm = jnn.Sequential().add(jnn.Linear(12, 6, with_bias=with_bias))
    jm.ensure_initialized()
    jm.evaluate()
    tm = load_jax_params(nn.Sequential(nn.Linear(12, 6,
                                                 with_bias=with_bias)),
                         jm.get_parameters()).eval()
    calib = [_rows(9, 16), _rows(10, 16)]
    x = _rows(11, 5)
    jsvc = JaxService(config=JaxConfig(max_batch_size=8))
    tsvc = _service(max_batch_size=8)
    try:
        jsvc.load("q", jm, quantize=True, calibration=calib)
        tsvc.load("q", tm, quantize=True, calibration=calib)
        want = np.asarray(jsvc.predict_batch("q", x))
        got = tsvc.predict_batch("q", x)
        if with_bias:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
        # the JAX package's eager forward of its quantized model: bitwise
        jq_m = jsvc.registry.current("q").model
        np.testing.assert_array_equal(
            got, np.asarray(jq_m.forward(jnp.asarray(x))))
    finally:
        jsvc.shutdown()
        tsvc.shutdown()

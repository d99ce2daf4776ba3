"""InferenceService — the serving façade (counterpart of
``bigdl_tpu.serving.service``).

``InferenceService(registry, config, device)`` wires the serving pieces
together per model name: requests enter a :class:`~bigdl_tpu_torch.
serving.batcher.MicroBatcher`, each batch resolves ONE servable from
the :class:`~bigdl_tpu_torch.serving.registry.ModelRegistry` (hot-swap
atomicity) and runs through the :class:`~bigdl_tpu_torch.serving.
compile_cache.CompileCache`'s per-rung eval program, padded to a rung
of the :class:`~bigdl_tpu_torch.serving.compile_cache.BucketLadder`. A
per-name :class:`~bigdl_tpu_torch.serving.breaker.CircuitBreaker` sheds
load after repeated dispatch failures::

    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.precision import AccuracyGate
    from bigdl_tpu_torch.serving import InferenceService, ServingConfig

    svc = InferenceService(config=ServingConfig(max_batch_size=64))
    model = ResNet(1000, depth=50, dataset="ImageNet").eval()
    svc.load("f32", model, warmup_shape=(3, 224, 224))
    svc.load("int8", model, quantize=True, calibration=batches,
             accuracy_gate=AccuracyGate(rows, max_delta=0.02),
             warmup_shape=(3, 224, 224))
    logits = svc.predict("int8", image)             # one row
    logits = svc.predict_batch("int8", images)      # rows together

The service runs on the card (``device=None`` → ``"cuda"``, raising when
CUDA is missing) unless the caller passes ``device="cpu"``. Requests
and results are numpy arrays; each batch is copied to the device and
its result back on the batcher's dispatch thread, which enters
``torch.inference_mode`` itself (the mode is per thread) and launches
on that thread's current stream (the default stream).

Not ported yet: the ``serving/dispatch`` fault point, the TensorBoard
export of the metrics, and ``load(path=)`` / ``input_spec=`` (the
registry raises NotImplementedError for both).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from bigdl_tpu_torch.serving.batcher import MicroBatcher
from bigdl_tpu_torch.serving.breaker import CircuitBreaker, Degraded
from bigdl_tpu_torch.serving.compile_cache import BucketLadder, CompileCache
from bigdl_tpu_torch.serving.registry import ModelRegistry, Servable
from bigdl_tpu_torch.telemetry import MetricsRegistry, percentile_summary
from bigdl_tpu_torch.utils.engine import model_device, resolve_device

__all__ = ["InferenceService", "ServingConfig"]


@dataclass
class ServingConfig:
    """Tuning surface. ``max_wait_ms`` trades tail latency for batch
    fill: a full batch dispatches immediately, an underfilled one waits
    at most this long for stragglers. ``buckets`` overrides the
    powers-of-two ladder (its max then bounds the batch size).
    ``breaker_failures`` consecutive dispatch failures open a per-model
    circuit breaker (submits fast-reject with :class:`Degraded` until a
    cooldown half-opens it; 0 disables)."""
    max_batch_size: int = 32
    max_wait_ms: float = 2.0
    max_queue: int = 256
    timeout_ms: Optional[float] = None
    buckets: Optional[Sequence[int]] = None
    breaker_failures: int = 8
    breaker_cooldown_ms: float = 1000.0


class InferenceService:
    """The serving façade: ``predict(name, x)`` (sync and future forms)
    over a hot-swappable multi-model registry, with per-model
    micro-batching, per-rung programs and serving metrics (module
    docstring has the wiring)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 config: Optional[ServingConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 metrics_registry: Optional[MetricsRegistry] = None):
        self.device = resolve_device(device)
        self.registry = registry or ModelRegistry()
        self.config = config or ServingConfig()
        self.ladder = BucketLadder(self.config.max_batch_size,
                                   self.config.buckets)
        # every serving instrument reports through ONE registry, private
        # to this service by default so concurrent services never mix
        self.metrics_registry = metrics_registry \
            if metrics_registry is not None else MetricsRegistry()
        self.cache = CompileCache(metrics=self.metrics_registry)
        # guards _batchers + _shut_down: a batcher owns a dispatch
        # thread, so creation is once per name and must not race
        # shutdown's iteration
        self._lock = threading.Lock()
        self._batchers: Dict[str, MicroBatcher] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._c_shed = self.metrics_registry.counter(
            "serving/service/shed",
            "requests fast-rejected by an open circuit breaker")
        self._shut_down = False

    # ------------------------------------------------------- lifecycle
    def load(self, name: str, model: Optional[torch.nn.Module] = None, *,
             path: Optional[str] = None, version: Optional[int] = None,
             quantize: bool = False, calibration=None, accuracy_gate=None,
             activate: bool = True,
             warmup_shape: Optional[Sequence[int]] = None,
             warmup_dtype: torch.dtype = torch.float32) -> Servable:
        """Registry load + (optionally) eager per-rung warmup.

        ``model`` must be in evaluation mode on the service's device.
        With ``warmup_shape`` (per-sample feature shape, no batch dim)
        the version is registered inactive, every ladder rung is built
        and run once, and only then swapped in — a hot-swap under live
        traffic never serves a cold rung. ``quantize`` /
        ``calibration`` / ``accuracy_gate`` ride through to
        :meth:`ModelRegistry.load`: a refused candidate builds nothing
        and the old version keeps serving."""
        if model is not None:
            dev = model_device(model)
            if dev.type != self.device.type or (
                    self.device.index is not None and dev != self.device):
                raise ValueError(f"model is on {dev}, the service on "
                                 f"{self.device}: build or move it there "
                                 f"first")
            if model.training:
                raise ValueError(
                    "model is in training mode: call .eval() before "
                    "serving it (the serving forward is an inference "
                    "forward)")
        servable = self.registry.load(
            name, model, path=path, version=version, quantize=quantize,
            calibration=calibration, accuracy_gate=accuracy_gate,
            activate=False)
        if warmup_shape is not None:
            self.cache.warmup(servable.key, servable.model, warmup_shape,
                              self.ladder, warmup_dtype)
        if activate:
            self.registry.swap(name, servable.version)
        return servable

    def warmup(self, name: str, feature_shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> int:
        """Build and run every rung for the CURRENT version of
        ``name``; returns how many programs that built."""
        s = self.registry.current(name)
        return self.cache.warmup(s.key, s.model, feature_shape,
                                 self.ladder, dtype)

    def swap(self, name: str, version: int) -> Servable:
        """Atomic hot-swap: already-dispatched batches finish on the
        servable they resolved; every later batch serves ``version``."""
        return self.registry.swap(name, version)

    def unload(self, name: str, version: Optional[int] = None) -> None:
        """Unload a version (or a whole name, draining its batcher) and
        release its programs."""
        if version is None:
            with self._lock:
                b = self._batchers.pop(name, None)
                # a reloaded name must not inherit a stale open circuit
                self._breakers.pop(name, None)
            if b is not None:
                b.shutdown(drain=True)
        for key in self.registry.unload(name, version):
            self.cache.drop(key)

    def shutdown(self, drain: bool = True) -> None:
        """Stop admission on every batcher; with ``drain`` serve
        everything queued first. Joins every dispatch thread."""
        with self._lock:
            self._shut_down = True
            batchers = list(self._batchers.values())
        for b in batchers:
            b.shutdown(drain=drain)

    # --------------------------------------------------------- predict
    def _run(self, name: str, x: np.ndarray) -> np.ndarray:
        """One padded batch on the dispatch thread: ONE registry read
        (the servable cannot change under a batch), the rung's program,
        the result back on the host."""
        s = self.registry.current(name)
        step = self.cache.step_for(s.key, s.model, x.shape[0])
        out = step(torch.from_numpy(np.ascontiguousarray(x))
                   .to(self.device))
        return out.cpu().numpy()

    def _batcher(self, name: str) -> MicroBatcher:
        with self._lock:
            b = self._batchers.get(name)
            if b is None:
                if self._shut_down:
                    raise RuntimeError("InferenceService is shut down")
                self.registry.current(name)  # fail fast on unknown names
                breaker = CircuitBreaker(self.config.breaker_failures,
                                         self.config.breaker_cooldown_ms)
                self._breakers[name] = breaker

                def run_batch(x, name=name, breaker=breaker):
                    try:
                        out = self._run(name, x)
                    except Exception:
                        breaker.on_failure()
                        raise
                    breaker.on_success()
                    return out

                b = MicroBatcher(run_batch, self.ladder,
                                 max_wait_ms=self.config.max_wait_ms,
                                 max_queue=self.config.max_queue,
                                 name=name, metrics=self.metrics_registry)
                self._batchers[name] = b
        return b

    def _submit(self, name: str, x, timeout_ms: Optional[float]) -> Future:
        """Breaker-gated admission: an open circuit fast-rejects with
        :class:`Degraded` (counted into ``serving/service/shed``)."""
        b = self._batcher(name)
        breaker = self._breakers.get(name)
        if breaker is not None and not breaker.allow():
            self._c_shed.inc(model=name)
            raise Degraded(
                f"{name}: circuit open after {breaker.failures} "
                f"consecutive dispatch failures; retry after "
                f"{breaker.cooldown_s * 1000:.0f}ms")
        return b.submit(x, timeout_ms if timeout_ms is not None
                        else self.config.timeout_ms)

    def predict_async(self, name: str, x,
                      timeout_ms: Optional[float] = None) -> Future:
        """One SAMPLE in -> Future of one prediction row."""
        fut = self._submit(name, np.asarray(x)[None], timeout_ms)
        out: Future = Future()
        fut.add_done_callback(lambda f: _chain(f, out, lambda o: o[0]))
        return out

    def predict(self, name: str, x, timeout_ms: Optional[float] = None):
        """Sync single-sample predict (blocks on the micro-batch)."""
        return self.predict_async(name, x, timeout_ms).result()

    def predict_batch_async(self, name: str, x,
                            timeout_ms: Optional[float] = None) -> Future:
        """``(rows, features...)`` in -> Future of ``(rows, ...)``
        predictions; the rows ride one micro-batch together."""
        return self._submit(name, np.asarray(x), timeout_ms)

    def predict_batch(self, name: str, x,
                      timeout_ms: Optional[float] = None):
        return self.predict_batch_async(name, x, timeout_ms).result()

    # --------------------------------------------------------- metrics
    def compile_count(self, name: str,
                      version: Optional[int] = None) -> int:
        """Programs built for ``name`` (one version, or all) — at most
        one per ladder rung per version."""
        versions = [version] if version is not None \
            else self.registry.versions(name)
        return sum(self.cache.compile_count((name, v)) for v in versions)

    def metrics(self, name: str) -> Dict[str, float]:
        """Point-in-time serving stats for one model name: request, row,
        rejection, timeout and error counts, batch fill, padded-row
        ratio, queue depth, sheds, latency percentiles and the program
        count."""
        with self._lock:
            b = self._batchers.get(name)
        out: Dict[str, float] = {
            "request_count": 0, "rows": 0, "rejected": 0, "timed_out": 0,
            "errors": 0, "batch_count": 0, "batch_fill": 0.0,
            "padded_row_ratio": 0.0, "queue_depth": 0,
            "shed": 0, "worker_restarts": 0, "failed_batches": 0,
        }
        if b is not None:
            # one locked multi-counter view: the ratios below must not
            # mix counters from different instants
            st = b.stats.snapshot()
            padded = st["batched_rows"] + st["padded_rows"]
            out.update(
                request_count=st["requests"], rows=st["rows"],
                rejected=st["rejected"], timed_out=st["timed_out"],
                errors=st["errors"], batch_count=st["batches"],
                worker_restarts=st["worker_restarts"],
                failed_batches=st["failed_batches"],
                batch_fill=(st["fill_sum"] / st["batches"]
                            if st["batches"] else 0.0),
                padded_row_ratio=(st["padded_rows"] / padded
                                  if padded else 0.0))
            out["queue_depth"] = b.queue_depth()
            out["shed"] = int(self._c_shed.value(model=name))
            for k, v in percentile_summary(st["latencies_ms"],
                                           (50, 99)).items():
                out[f"latency_ms_{k}"] = v
        out["compile_count"] = self.compile_count(name)
        return out

    def breaker_state(self, name: str) -> str:
        """The model's circuit-breaker state (``"closed"`` before any
        traffic has created its batcher)."""
        with self._lock:
            breaker = self._breakers.get(name)
        return breaker.state if breaker is not None else "closed"


def _chain(src: Future, dst: Future, fn) -> None:
    """Propagate src's outcome into dst through fn (row-slice views)."""
    if src.cancelled():
        dst.cancel()
        return
    e = src.exception()
    if e is not None:
        dst.set_exception(e)
    else:
        dst.set_result(fn(src.result()))

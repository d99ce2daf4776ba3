"""Dynamic micro-batcher: the request→batch coalescing core of serving
(counterpart of ``bigdl_tpu.serving.batcher``).

Callers submit single requests (or small row-batches) and get a Future;
a dispatch thread coalesces queued requests up to ``max_batch_size``
rows or until the oldest request has waited ``max_wait_ms``, right-pads
the coalesced rows to the nearest ``BucketLadder`` rung (:func:`pad_rows`
— repeat the last real row), runs ONE forward via the injected
``run_batch`` callable, and scatters per-request row slices back to the
futures. A full batch dispatches immediately — ``max_wait_ms`` is the
latency bound for underfilled batches, not a tax on busy traffic.

Admission control:

- bounded queue depth — ``submit`` raises :class:`QueueFull` at once
  instead of buffering unboundedly;
- per-request deadlines — a request that waits past its budget fails
  with :class:`DeadlineExceeded` (and the batch window never waits
  beyond the earliest queued deadline);
- graceful drain — ``shutdown(drain=True)`` stops admission, flushes
  everything queued, then joins the dispatch thread;
- supervision — a death of the dispatch loop outside the per-batch
  error handling fails every pending future with :class:`WorkerDied`
  and restarts the loop.

The batcher is model-agnostic (``run_batch`` is any padded-rows →
padded-rows callable over numpy arrays), which is also what lets tests
drive it with a slow pure-python runner to exercise the rejection and
timeout paths. The caller's ``run_batch`` runs on the dispatch thread;
state that PyTorch keeps per thread (``torch.inference_mode``, the
current CUDA stream) is the caller's to set there.

Taking a batch off the queue passes the ``serving/take_batch`` fault
point (:mod:`bigdl_tpu_torch.faults`), where a death would strand popped
requests: the supervisor fails them typed. Not ported yet: the flight
recorder's post-mortem on a worker death, and per-request trace ids and
trace tracks (they wait for the port's tracer).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from bigdl_tpu_torch import faults
from bigdl_tpu_torch.serving.compile_cache import BucketLadder
from bigdl_tpu_torch.serving.errors import (DeadlineExceeded, QueueFull,
                                            WorkerDied)
from bigdl_tpu_torch.telemetry import MetricsRegistry

__all__ = ["BatcherStats", "MicroBatcher", "pad_rows"]


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Right-pad dim 0 to ``n`` rows by repeating the last row: a real
    row keeps the pad numerically inert for row-wise models while
    pinning the batch shape to a rung."""
    if a.shape[0] == n:
        return a
    if a.shape[0] > n:
        raise ValueError(f"batch of {a.shape[0]} rows exceeds {n}")
    reps = np.repeat(a[-1:], n - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


class _Request:
    __slots__ = ("x", "n_rows", "future", "deadline", "t_enqueue")

    def __init__(self, x: np.ndarray, deadline: Optional[float]):
        self.x = x
        self.n_rows = x.shape[0]
        self.future: Future = Future()
        self.deadline = deadline
        self.t_enqueue = time.monotonic()


class BatcherStats:
    """Batcher counters, routed through a telemetry
    :class:`~bigdl_tpu_torch.telemetry.MetricsRegistry` (series are
    labelled ``model=<name>``, so one service's batchers share
    instruments). The attribute surface (``requests``, ``timed_out``,
    ``latencies_ms``, ... and the public ``lock``) reads the series."""

    def __init__(self, reservoir: int = 2048, registry=None,
                 model: str = "model"):
        self.lock = threading.Lock()
        r = registry if registry is not None else MetricsRegistry()
        self.registry = r
        self._labels = {"model": model}
        self._c_requests = r.counter(
            "serving/batcher/requests", "requests admitted")
        self._c_rows = r.counter(
            "serving/batcher/rows", "request rows admitted")
        self._c_rejected = r.counter(
            "serving/batcher/rejected",
            "requests rejected at admission (QueueFull)")
        self._c_timed_out = r.counter(
            "serving/batcher/timed_out",
            "requests failed past their deadline (deadline misses)")
        self._c_errors = r.counter(
            "serving/batcher/errors", "requests failed by a batch error")
        self._c_failed_batches = r.counter(
            "serving/batcher/failed_batches",
            "batches whose dispatch raised (one per failed dispatch)")
        self._c_worker_restarts = r.counter(
            "serving/batcher/worker_restarts",
            "dispatch-thread deaths survived by supervision")
        self._c_worker_failed = r.counter(
            "serving/batcher/worker_failed",
            "requests failed with WorkerDied by a thread death")
        self._c_batches = r.counter(
            "serving/batcher/batches", "batches dispatched")
        self._c_batched_rows = r.counter(
            "serving/batcher/batched_rows",
            "real rows dispatched in batches")
        self._c_padded_rows = r.counter(
            "serving/batcher/padded_rows",
            "pad rows added to reach bucket rungs")
        self._c_fill_sum = r.counter(
            "serving/batcher/fill_sum", "sum of per-batch fill ratios")
        self._h_latency = r.histogram(
            "serving/batcher/latency_ms",
            "request latency enqueue -> result (ms)",
            reservoir_size=reservoir)
        self._h_queue_wait = r.histogram(
            "serving/batcher/queue_wait_ms",
            "request wait enqueue -> batch dispatch (ms)",
            reservoir_size=reservoir)
        self._h_batch_rows = r.histogram(
            "serving/batcher/batch_rows",
            "real rows per dispatched batch", reservoir_size=reservoir)
        self._g_depth = r.gauge(
            "serving/batcher/queue_depth", "requests waiting in queue")

    # -- writers (called by MicroBatcher only) ---------------------------
    def on_reject(self) -> None:
        """Count one QueueFull admission rejection."""
        with self.lock:
            self._c_rejected.inc(**self._labels)

    def on_submit(self, rows: int) -> None:
        """Count one admitted request of ``rows`` rows."""
        with self.lock:
            self._c_requests.inc(**self._labels)
            self._c_rows.inc(rows, **self._labels)

    def on_timeout(self) -> None:
        """Count one deadline miss."""
        with self.lock:
            self._c_timed_out.inc(**self._labels)

    def on_error(self, n_requests: int) -> None:
        """Count ``n_requests`` failed by one batch error."""
        with self.lock:
            self._c_errors.inc(n_requests, **self._labels)
            self._c_failed_batches.inc(**self._labels)

    def on_worker_death(self, n_requests: int) -> None:
        """Count one dispatch-thread death that failed ``n_requests``
        pending requests with WorkerDied."""
        with self.lock:
            self._c_worker_restarts.inc(**self._labels)
            self._c_worker_failed.inc(n_requests, **self._labels)

    def on_batch(self, rows: int, bucket: int) -> None:
        """Count one dispatched batch of ``rows`` real rows padded to
        ``bucket``."""
        with self.lock:
            self._c_batches.inc(**self._labels)
            self._c_batched_rows.inc(rows, **self._labels)
            self._c_padded_rows.inc(bucket - rows, **self._labels)
            self._c_fill_sum.inc(rows / bucket, **self._labels)
            self._h_batch_rows.observe(rows, **self._labels)

    def on_latency(self, ms: float) -> None:
        """Record one request's enqueue->result latency."""
        self._h_latency.observe(ms, **self._labels)

    def on_queue_wait(self, ms: float) -> None:
        """Record one request's enqueue->dispatch wait."""
        self._h_queue_wait.observe(ms, **self._labels)

    def on_depth(self, depth: int) -> None:
        """Publish the current queue depth."""
        self._g_depth.set(depth, **self._labels)

    # -- consistent multi-counter reads ----------------------------------
    def snapshot(self) -> Dict[str, object]:
        """One consistent view of the whole counter family, read under
        ``self.lock``. The bare properties below are each internally
        consistent (their instrument lock suffices) but can tear ACROSS
        counters — a writer like :meth:`on_batch` may land between two
        property reads, so derived ratios (``fill_sum / batches``,
        padded-row ratio) must come from here."""
        with self.lock:
            return {
                "requests": self.requests, "rows": self.rows,
                "rejected": self.rejected, "timed_out": self.timed_out,
                "errors": self.errors,
                "failed_batches": self.failed_batches,
                "worker_restarts": self.worker_restarts,
                "worker_failed": self.worker_failed,
                "batches": self.batches,
                "batched_rows": self.batched_rows,
                "padded_rows": self.padded_rows,
                "fill_sum": self.fill_sum,
                "latencies_ms": list(self.latencies_ms),
            }

    # -- legacy read surface ---------------------------------------------
    def _count(self, c) -> int:
        return int(c.value(**self._labels))

    @property
    def requests(self) -> int:
        """Requests admitted."""
        return self._count(self._c_requests)

    @property
    def rows(self) -> int:
        """Request rows admitted."""
        return self._count(self._c_rows)

    @property
    def rejected(self) -> int:
        """Requests rejected at admission."""
        return self._count(self._c_rejected)

    @property
    def timed_out(self) -> int:
        """Requests failed past their deadline."""
        return self._count(self._c_timed_out)

    @property
    def errors(self) -> int:
        """Requests failed by a batch error."""
        return self._count(self._c_errors)

    @property
    def failed_batches(self) -> int:
        """Batches whose dispatch raised."""
        return self._count(self._c_failed_batches)

    @property
    def worker_restarts(self) -> int:
        """Dispatch-thread deaths survived by supervision."""
        return self._count(self._c_worker_restarts)

    @property
    def worker_failed(self) -> int:
        """Requests failed with WorkerDied."""
        return self._count(self._c_worker_failed)

    @property
    def batches(self) -> int:
        """Batches dispatched."""
        return self._count(self._c_batches)

    @property
    def batched_rows(self) -> int:
        """Real rows dispatched."""
        return self._count(self._c_batched_rows)

    @property
    def padded_rows(self) -> int:
        """Pad rows added."""
        return self._count(self._c_padded_rows)

    @property
    def fill_sum(self) -> float:
        """Sum of per-batch fill ratios."""
        return self._c_fill_sum.value(**self._labels)

    @property
    def latencies_ms(self) -> List[float]:
        """The bounded latency reservoir (ms, oldest first)."""
        return self._h_latency.samples(**self._labels)


class MicroBatcher:
    """Queue + dispatch thread coalescing requests into bucket-padded
    batches for one ``run_batch`` callable (module docstring has the
    batching window and admission-control rules)."""

    def __init__(self, run_batch: Callable[[np.ndarray], np.ndarray],
                 ladder: BucketLadder, *, max_wait_ms: float = 2.0,
                 max_queue: int = 256, name: str = "model",
                 metrics=None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._run_batch = run_batch
        self._ladder = ladder
        self._max_wait = max_wait_ms / 1000.0
        self._max_queue = max_queue
        self._name = name
        # ``metrics``: the telemetry MetricsRegistry to report through
        # (an InferenceService passes its own so concurrent services
        # don't mix counts); default is a private registry
        self.stats = BatcherStats(registry=metrics, model=name)
        #: (feature_shape, dtype) CONFIRMED by the first successful
        #: dispatch; requests coalesce into ONE ndarray, so a mismatch
        #: must be rejected at admission (its whole batch would fail
        #: on concatenate, or silently upcast and double-compile).
        #: Until confirmed, submits are checked against what's queued —
        #: a malformed lone first request fails its own forward without
        #: permanently bricking the name.
        self._sig = None
        self._queue: Deque[_Request] = deque()
        self._cond = threading.Condition()
        self._stopping = False
        #: requests popped from the queue but not yet resolved by
        #: _dispatch — the supervisor fails THESE too on a worker
        #: death (a crash between take and dispatch must not strand
        #: popped futures). Worker-thread-only state.
        self._inflight: List[_Request] = []
        self._thread = threading.Thread(
            target=self._supervised, name=f"serving-batcher-{name}",
            daemon=True)
        self._thread.start()

    @property
    def max_batch_size(self) -> int:
        return self._ladder.max_batch_size

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # -------------------------------------------------------- submit
    def submit(self, x: np.ndarray,
               timeout_ms: Optional[float] = None) -> Future:
        """Enqueue a (rows, features...) request; returns its Future.

        Raises :class:`QueueFull` immediately when the queue is at
        depth (explicit rejection beats unbounded buffering), and
        ValueError for requests wider than one batch (split upstream)
        or whose feature shape/dtype differs from the batcher's
        established signature (one malformed request must never fail
        the well-formed requests it would have been batched with).
        """
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"request needs >= 1 rows, got shape {x.shape}")
        if x.shape[0] > self.max_batch_size:
            raise ValueError(
                f"request of {x.shape[0]} rows exceeds max_batch_size="
                f"{self.max_batch_size}; split it upstream")
        deadline = (time.monotonic() + timeout_ms / 1000.0
                    if timeout_ms is not None else None)
        req = _Request(x, deadline)
        sig = (x.shape[1:], x.dtype)
        with self._cond:
            if self._stopping:
                raise RuntimeError(f"batcher {self._name!r} is shut down")
            ref = self._sig or (
                (self._queue[-1].x.shape[1:], self._queue[-1].x.dtype)
                if self._queue else None)
            if ref is not None and sig != ref:
                raise ValueError(
                    f"{self._name}: request feature shape/dtype "
                    f"{sig[0]}/{sig[1]} does not match this model's "
                    f"established {ref[0]}/{ref[1]} — one "
                    "micro-batched service serves one input signature")
            if len(self._queue) >= self._max_queue:
                self.stats.on_reject()
                raise QueueFull(
                    f"{self._name}: queue at max depth {self._max_queue}")
            self._queue.append(req)
            self.stats.on_submit(req.n_rows)
            self.stats.on_depth(len(self._queue))
            self._cond.notify_all()
        return req.future

    # ------------------------------------------------------ dispatch
    def _queued_rows_locked(self) -> int:
        rows, cap = 0, self.max_batch_size
        for r in self._queue:
            if rows + r.n_rows > cap:
                break
            rows += r.n_rows
        return rows

    def _window_end_locked(self, now: float) -> float:
        """The moment this batch must dispatch: the head request's
        max_wait budget, tightened by the earliest queued deadline."""
        end = self._queue[0].t_enqueue + self._max_wait
        for r in self._queue:
            if r.deadline is not None:
                end = min(end, r.deadline)
        return end

    def _take_batch_locked(self, window_open: float):
        """Pop expired requests (failing their futures) and then up to
        max_batch_size rows of live ones.

        "Expired" means the deadline passed BEFORE this batching round
        opened — i.e. the batcher was busy elsewhere while the budget
        ran out. A deadline the window itself closed on is SERVED: the
        window end is tightened to the earliest queued deadline exactly
        so that request dispatches as its budget expires, rather than
        being failed by the wakeup meant to serve it (a request with
        timeout_ms <= max_wait_ms must still work on an idle server).
        """
        batch = self._inflight  # crash-visible to the supervisor
        rows, cap = 0, self.max_batch_size
        while self._queue:
            r = self._queue[0]
            if r.deadline is not None and r.deadline < window_open:
                self._queue.popleft()
                self.stats.on_timeout()
                r.future.set_exception(DeadlineExceeded(
                    f"{self._name}: request waited past its deadline"))
                continue
            if rows + r.n_rows > cap:
                break
            self._queue.popleft()
            batch.append(r)
            rows += r.n_rows
        # the batching-machinery death site: requests are popped but not
        # yet dispatched, where an unsupervised loop would strand them
        faults.point("serving/take_batch", model=self._name, rows=rows)
        return batch, rows

    def _supervised(self) -> None:
        """Run ``_loop``, surviving its death: a crash OUTSIDE
        ``_dispatch``'s per-batch error handling (the batching
        machinery itself) fails every pending future — queued AND
        popped-but-undispatched — with a typed :class:`WorkerDied`
        instead of leaving them pending forever, then restarts the
        loop so the batcher keeps serving."""
        while True:
            try:
                self._loop()
                return  # clean shutdown
            except Exception as e:  # noqa: BLE001 — supervision
                with self._cond:
                    died = list(self._inflight) + list(self._queue)
                    self._inflight = []
                    self._queue.clear()
                    restart = not self._stopping
                    self.stats.on_worker_death(len(died))
                    self.stats.on_depth(0)
                    self._cond.notify_all()
                err = WorkerDied(
                    f"batcher {self._name!r} dispatch worker died: "
                    f"{type(e).__name__}: {e}")
                err.__cause__ = e
                for r in died:
                    # in-flight requests may already be resolved (a
                    # crash in post-dispatch bookkeeping) or racing a
                    # caller's cancel — failing THOSE would raise
                    # InvalidStateError and kill the supervisor itself
                    try:
                        if not r.future.done():
                            r.future.set_exception(err)
                    except Exception:
                        pass  # resolved/cancelled in the race window
                if not restart:
                    return

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if not self._queue and self._stopping:
                    return
                # hold the window open for stragglers until the batch
                # fills, the head request's wait budget ends, or drain
                window_open = time.monotonic()
                while not self._stopping:
                    now = time.monotonic()
                    if self._queued_rows_locked() >= self.max_batch_size:
                        break
                    remaining = self._window_end_locked(now) - now
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch, rows = self._take_batch_locked(window_open)
                self.stats.on_depth(len(self._queue))
            if batch:
                self._dispatch(batch, rows)
            with self._cond:
                # cleared under the lock: the supervisor's crash-path
                # rebind of _inflight must never race this one
                self._inflight = []

    def _dispatch(self, batch: List[_Request], rows: int) -> None:
        bucket = self._ladder.bucket_for(rows)
        t_dispatch = time.monotonic()
        for r in batch:
            self.stats.on_queue_wait((t_dispatch - r.t_enqueue) * 1000.0)
        x = np.concatenate([r.x for r in batch], axis=0) \
            if len(batch) > 1 else batch[0].x
        try:
            out = np.asarray(self._run_batch(pad_rows(x, bucket)))
            if out.shape[:1] != (bucket,):
                # a row-reducing model would otherwise scatter empty/
                # truncated slices into futures that "succeed"
                raise ValueError(
                    f"{self._name}: run_batch returned shape {out.shape} "
                    f"for a {bucket}-row padded batch; serving requires "
                    "one output row per input row")
        except Exception as e:  # noqa: BLE001 — failures go to futures
            self.stats.on_error(len(batch))
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        with self._cond:
            if self._sig is None:
                # confirmed by a successful forward: from here on the
                # name serves exactly this signature
                self._sig = (x.shape[1:], x.dtype)
        t_done = time.monotonic()
        self.stats.on_batch(rows, bucket)
        for r in batch:
            self.stats.on_latency((t_done - r.t_enqueue) * 1000.0)
        off = 0
        for r in batch:
            if not r.future.cancelled():
                # pad rows live PAST every request slice: they can
                # never leak into a scattered result
                r.future.set_result(out[off:off + r.n_rows])
            off += r.n_rows

    # ------------------------------------------------------ shutdown
    def shutdown(self, drain: bool = True) -> None:
        """Stop admission; with ``drain`` serve everything queued, else
        fail queued requests; then join the dispatch thread."""
        with self._cond:
            if self._stopping:
                self._cond.notify_all()
            self._stopping = True
            if not drain:
                while self._queue:
                    r = self._queue.popleft()
                    r.future.set_exception(
                        RuntimeError(f"batcher {self._name!r} shut down"))
            self._cond.notify_all()
        self._thread.join()

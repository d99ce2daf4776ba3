"""Circuit breaker: shed load fast when the backend is failing
(counterpart of ``bigdl_tpu.serving.breaker``, unchanged).

When a model's dispatch path fails repeatedly (a bad weight push, a
wedged device, a dependency outage), continuing to queue requests just
converts every caller's latency budget into a slow failure. The
breaker turns ``K`` *consecutive* dispatch failures into fast
rejection (:class:`Degraded` raised at submit time — the caller learns
in microseconds, queue depth stays available for models that work),
then **half-opens** after a cooldown: one probe request is admitted,
and its outcome closes the circuit (success) or re-opens it for
another cooldown (failure). The classic states:

- ``closed``  — normal service; failures count, any success resets.
- ``open``    — shedding; every ``allow()`` is False until the
  cooldown elapses.
- ``half-open`` — exactly one probe in flight; its outcome decides.

``InferenceService`` wires one breaker per model name around the
batcher's ``run_batch``; shed requests count into the
``serving/service/shed`` telemetry series.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

__all__ = ["CircuitBreaker", "Degraded"]


class Degraded(RuntimeError):
    """Fast-reject: the model's circuit breaker is open after repeated
    consecutive dispatch failures; retry after its cooldown."""


class CircuitBreaker:
    """Consecutive-failure circuit breaker (module docstring has the
    state machine). ``failures <= 0`` disables the breaker — every
    ``allow()`` is True and outcomes are ignored. Thread-safe: submit
    paths call :meth:`allow`, the dispatch thread reports
    :meth:`on_success`/:meth:`on_failure`."""

    def __init__(self, failures: int = 8, cooldown_ms: float = 1000.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failures = int(failures)
        self.cooldown_s = float(cooldown_ms) / 1000.0
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_at = 0.0

    @property
    def state(self) -> str:
        """``"closed"``, ``"open"`` or ``"half-open"`` (reading an
        elapsed cooldown does not itself transition — the next
        ``allow()`` does)."""
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """Whether one request may proceed now. In ``open``, flips to
        ``half-open`` once the cooldown has elapsed and admits exactly
        ONE probe; further requests shed until the probe resolves — or
        until a cooldown passes with no outcome (a probe can die
        before reaching dispatch: queue-full rejection, deadline
        expiry, a worker death clearing the queue), in which case a
        fresh probe is admitted rather than shedding forever."""
        if self.failures <= 0:
            return True
        with self._lock:
            now = self._clock()
            if self._state == "closed":
                return True
            if self._state == "open":
                if now - self._opened_at < self.cooldown_s:
                    return False
                self._state = "half-open"
                return self._claim_probe(now)
            # half-open: one probe at a time, re-armed if the probe
            # vanished without reporting an outcome
            return self._claim_probe(now)

    def _claim_probe(self, now: float) -> bool:
        """Single-flight claim of THE half-open probe slot (caller
        holds the lock). A held slot only counts as vanished once
        STRICTLY more than a cooldown passes with no outcome — ``<=``
        matters: with a zero (or coarse) cooldown, two submits racing
        the same clock reading would otherwise both claim and
        half-open would admit two concurrent probes."""
        if self._probing and now - self._probe_at <= self.cooldown_s:
            return False
        self._probing = True
        self._probe_at = now
        return True

    def on_success(self) -> None:
        """A dispatch succeeded: reset to ``closed``."""
        if self.failures <= 0:
            return
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._probing = False

    def on_failure(self) -> None:
        """A dispatch failed: count it; ``K`` consecutive failures (or
        a failed half-open probe) open the circuit for a cooldown."""
        if self.failures <= 0:
            return
        with self._lock:
            self._consecutive += 1
            if self._state == "half-open" \
                    or self._consecutive >= self.failures:
                self._state = "open"
                self._opened_at = self._clock()
                self._probing = False

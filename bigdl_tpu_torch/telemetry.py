"""Metrics registry: named Counter / Gauge / Histogram instruments with
label series (the slice of ``bigdl_tpu.telemetry`` the serving path
and the kernel dispatch read).

Names follow ``family/component/metric``; labels are per-call kwargs
(``requests.inc(model="lm")``) and each distinct label set is its own
series. Histograms keep an exact count plus a bounded sample reservoir
digested by :func:`percentile_summary`. Instruments are
always on — ``GenerationService.metrics()`` is public API — cost one
lock and one dict update each, and start no thread and open no file.

Not ported yet: spans, the tracer, exporters and the flight recorder.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "percentile_summary"]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile_summary(samples, qs=(50, 90, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p99": ...}`` over ``samples``; ``{}`` when
    empty."""
    arr = np.asarray(list(samples), np.float64)
    if arr.size == 0:
        return {}
    return {f"p{int(q)}": float(np.percentile(arr, q)) for q in qs}


class _Instrument:
    kind = "instrument"

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, object] = {}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"

    def series(self) -> Dict[LabelKey, object]:
        """A copy of ``{label key: value}`` over every series (a label
        key is the sorted ``((name, value), ...)`` of its labels)."""
        with self._lock:
            return dict(self._values)


class Counter(_Instrument):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(amount={amount})")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """The sum over every label series."""
        with self._lock:
            return float(sum(self._values.values()))


class Gauge(_Instrument):
    """Point-in-time level."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)


class _HistoSeries:
    __slots__ = ("count", "reservoir")

    def __init__(self, reservoir_size: int):
        self.count = 0
        self.reservoir: deque = deque(maxlen=reservoir_size)


class Histogram(_Instrument):
    """Distribution of observations: exact count plus a bounded
    reservoir of the newest samples."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 reservoir_size: int = 2048):
        super().__init__(name, description)
        self.reservoir_size = reservoir_size

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            s = self._values.get(key)
            if s is None:
                s = self._values[key] = _HistoSeries(self.reservoir_size)
            s.count += 1
            s.reservoir.append(v)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._values.get(_label_key(labels))
            return s.count if s else 0

    def samples(self, **labels) -> List[float]:
        with self._lock:
            s = self._values.get(_label_key(labels))
            return list(s.reservoir) if s else []


class MetricsRegistry:
    """Named instruments, get-or-create; a name registered as one kind
    and requested as another raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get(self, cls, name: str, description: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, description,
                                                     **kw)
            elif not isinstance(inst, cls):
                raise ValueError(f"{name!r} is already registered as a "
                                 f"{inst.kind}, not a {cls.kind}")
            return inst

    def counter(self, name: str, description: str = "") -> Counter:
        return self._get(Counter, name, description)

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._get(Gauge, name, description)

    def histogram(self, name: str, description: str = "",
                  reservoir_size: int = 2048) -> Histogram:
        return self._get(Histogram, name, description,
                         reservoir_size=reservoir_size)


#: the process-wide registry of module-level instruments (the kernel
#: dispatch counters, the accuracy gate's gauge); services keep
#: registries of their own
REGISTRY = MetricsRegistry()


def counter(name: str, description: str = "") -> Counter:
    """A counter in the process-wide :data:`REGISTRY`."""
    return REGISTRY.counter(name, description)


def gauge(name: str, description: str = "") -> Gauge:
    """A gauge in the process-wide :data:`REGISTRY`."""
    return REGISTRY.gauge(name, description)


def histogram(name: str, description: str = "") -> Histogram:
    """A histogram in the process-wide :data:`REGISTRY`."""
    return REGISTRY.histogram(name, description)

"""Shape-bucket ladder and the per-key program registry (counterpart of
``bigdl_tpu.serving.compile_cache``).

:class:`BucketLadder` is the JAX package's, unchanged: a ragged request
pads up to the nearest rung, so K rungs bound the shapes a servable
ever runs at. :class:`CompileCache` keeps its role and its counter: in
the JAX package a "program" is a jitted function and the counter
counts traces; here a program is a Python callable over device tensors
(a CUDA graph in a later change) and the counter counts builds — the
quantity the ≤ 2K-programs-per-version bound of generation and the
≤ 1-program-per-rung bound of :meth:`CompileCache.step_for` are
asserted on.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

from bigdl_tpu_torch.telemetry import MetricsRegistry
from bigdl_tpu_torch.utils.engine import model_device

__all__ = ["BucketLadder", "CompileCache"]


class BucketLadder:
    """Sorted size rungs; requests pad up to the nearest rung.

    Default ladder is powers of two up to ``max_batch_size`` (with
    ``max_batch_size`` itself as the top rung), e.g. 32 -> [1, 2, 4, 8,
    16, 32]; pass ``buckets`` for a custom ladder (deduped, sorted; its
    max becomes the effective max size)."""

    def __init__(self, max_batch_size: int,
                 buckets: Optional[Sequence[int]] = None):
        if buckets is not None:
            rungs = sorted(set(int(b) for b in buckets))
            if not rungs or rungs[0] < 1:
                raise ValueError(f"buckets must be positive ints, got "
                                 f"{list(buckets)}")
        else:
            if max_batch_size < 1:
                raise ValueError(
                    f"max_batch_size must be >= 1, got {max_batch_size}")
            rungs, b = [], 1
            while b < max_batch_size:
                rungs.append(b)
                b *= 2
            rungs.append(max_batch_size)
        self._rungs: List[int] = rungs

    @property
    def max_batch_size(self) -> int:
        return self._rungs[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n."""
        if n < 1:
            raise ValueError(f"batch of {n} rows")
        for b in self._rungs:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} rows exceeds the ladder's max "
                         f"{self.max_batch_size}")

    def __iter__(self) -> Iterator[int]:
        return iter(self._rungs)

    def __len__(self) -> int:
        return len(self._rungs)

    def __repr__(self) -> str:
        return f"BucketLadder({self._rungs})"


class CompileCache:
    """Per-key programs + a build counter.

    Keys are opaque hashables — the generation engine uses ``(name,
    version, kind, bucket)``, :meth:`step_for` ``(name, version,
    "eval", rows)`` — so two versions never share programs, and
    :meth:`compile_count` / :meth:`drop` of a servable's ``(name,
    version)`` cover every program keyed under it."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._programs: Dict = {}
        self._builds: Dict = {}
        r = metrics if metrics is not None else MetricsRegistry()
        self._m_hits = r.counter(
            "serving/compile_cache/hits",
            "program lookups served by an already-built program")
        self._m_misses = r.counter(
            "serving/compile_cache/misses",
            "program lookups that built a program")

    @staticmethod
    def _model_label(key) -> str:
        if isinstance(key, tuple) and key and isinstance(key[0], str):
            return key[0]
        return str(key)

    def program_for(self, key, build: Callable[[], Callable]) -> Callable:
        """The cached program for ``key``, built on first use by
        ``build() -> callable`` (counted once per key)."""
        label = self._model_label(key)
        with self._lock:
            prog = self._programs.get(key)
        if prog is not None:
            self._m_hits.inc(model=label)
            return prog
        prog = build()
        with self._lock:
            # two racing builders: keep the first, count one build
            cached = self._programs.setdefault(key, prog)
            if cached is prog:
                self._builds[key] = self._builds.get(key, 0) + 1
        if cached is prog:
            self._m_misses.inc(model=label)
        else:
            self._m_hits.inc(model=label)
        return cached

    def step_for(self, key, model, rows: int) -> Callable:
        """The eval program of servable ``key`` at one rung of ``rows``
        (counterpart of the JAX package's jitted eval step, whose
        per-shape traces this per-rung build count stands for):
        ``x [rows, ...] -> model(x)`` under ``torch.inference_mode``,
        entered inside the call because the mode is per thread."""
        def build():
            def step(x):
                with torch.inference_mode():
                    return model(x)
            return step

        return self.program_for(tuple(key) + ("eval", int(rows)), build)

    def warmup(self, key, model, feature_shape: Sequence[int],
               ladder: BucketLadder, dtype=torch.float32) -> int:
        """Build and run the program of every ladder rung for ``key``
        (a zeros input of shape ``(rung,) + feature_shape`` on the
        model's device), so no real request pays a first call. Returns
        the number of programs this call built."""
        device = model_device(model)
        before = self.compile_count(key)
        for b in ladder:
            x = torch.zeros((b,) + tuple(feature_shape), dtype=dtype,
                            device=device)
            self.step_for(key, model, b)(x)
        if device.type == "cuda":
            # warmup gates on every rung having run to the end
            torch.cuda.synchronize(device)
        return self.compile_count(key) - before

    @staticmethod
    def _under(program_key, key) -> bool:
        if program_key == key:
            return True
        return (isinstance(program_key, tuple) and isinstance(key, tuple)
                and program_key[:len(key)] == key)

    def compile_count(self, key=None) -> int:
        """Programs built so far — for ``key`` and every program keyed
        under it (a servable's ``(name, version)``), or in total."""
        with self._lock:
            if key is not None:
                return sum(n for k, n in self._builds.items()
                           if self._under(k, key))
            return sum(self._builds.values())

    def drop(self, key) -> None:
        """Release the programs of an unloaded servable (``key`` and
        every program keyed under it)."""
        with self._lock:
            for k in [k for k in self._programs if self._under(k, key)]:
                del self._programs[k]
            for k in [k for k in self._builds if self._under(k, key)]:
                del self._builds[k]

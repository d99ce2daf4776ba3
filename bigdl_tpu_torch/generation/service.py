"""GenerationService — the autoregressive-serving façade (counterpart of
``bigdl_tpu.generation.service``).

``GenerationService(registry, config, device)`` turns a decoder model
with the incremental-decode contract (``model(tokens, cache=,
positions=, attend_len=)`` —
:class:`~bigdl_tpu_torch.models.transformer.TransformerLM`) into a
token-streaming service: the :class:`~bigdl_tpu_torch.serving.registry.
ModelRegistry` for versioned hot-swap, the :class:`~bigdl_tpu_torch.
serving.compile_cache.CompileCache` for counted, bounded programs, and
one :class:`~bigdl_tpu_torch.generation.loop.DecodeLoop` per model name
for continuous batching::

    from bigdl_tpu_torch.generation import GenerationConfig, GenerationService
    from bigdl_tpu_torch.models import TransformerLM

    svc = GenerationService(config=GenerationConfig(slots=8, max_len=256))
    svc.load("lm", TransformerLM(vocab_size=8192, max_len=256))
    stream = svc.generate("lm", prompt_ids, max_new_tokens=32)
    for tok in stream:                         # tokens as they decode
        ...

The service runs on the card (``device=None`` → ``"cuda"``, raising
when CUDA is missing) unless the caller passes ``device="cpu"``.

Long prompts prefill in fixed chunks with
``GenerationConfig(prefill_chunk=C)`` (one program per rung still; the
``prefill_chunks`` metric counts the chunk calls). Not ported yet:
``apply_tuned_config``, the prefix cache and loading a version from a
checkpoint path.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from bigdl_tpu_torch.generation.engine import DecodeEngine
from bigdl_tpu_torch.generation.kv_cache import KVCache
from bigdl_tpu_torch.generation.loop import DecodeLoop
from bigdl_tpu_torch.generation.sampling import SamplingParams
from bigdl_tpu_torch.generation.stream import TokenStream
from bigdl_tpu_torch.serving.compile_cache import BucketLadder, CompileCache
from bigdl_tpu_torch.serving.registry import ModelRegistry, Servable
from bigdl_tpu_torch.telemetry import MetricsRegistry, percentile_summary
from bigdl_tpu_torch.utils.engine import resolve_device

__all__ = ["GenerationConfig", "GenerationService"]


@dataclass
class GenerationConfig:
    """Tuning surface. ``slots`` is the continuous-batching width;
    ``max_len`` bounds prompt+generation length and sizes the cache's
    time axis; ``length_buckets`` overrides the powers-of-two ladder
    (K rungs ⇒ ≤ 2K programs per version); ``prefill_rows`` is the
    padded-prompt batch width admissions share; ``timeout_ms`` the
    default per-request deadline (None = none); ``prefill_chunk``
    (long context) prefills prompts whose rung exceeds it in fixed
    ``[prefill_rows, chunk]`` pieces through the rung's one prefill
    program (it must divide every larger rung; None = single-shot)."""
    slots: int = 8
    max_len: int = 256
    length_buckets: Optional[Sequence[int]] = None
    prefill_rows: int = 4
    max_queue: int = 256
    eos_token: Optional[int] = None
    max_new_tokens: int = 64
    timeout_ms: Optional[float] = None
    prefill_chunk: Optional[int] = None


class GenerationService:
    """Token-streaming generation over a hot-swappable multi-model
    registry (module docstring has the wiring)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 config: Optional[GenerationConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 metrics_registry: Optional[MetricsRegistry] = None):
        self.device = resolve_device(device)
        self.registry = registry or ModelRegistry()
        self.config = config or GenerationConfig()
        self.ladder = BucketLadder(self.config.max_len,
                                   self.config.length_buckets)
        if self.ladder.max_batch_size != self.config.max_len:
            # the top rung IS the cache's time axis
            raise ValueError(
                f"length_buckets top rung {self.ladder.max_batch_size} "
                f"must equal max_len={self.config.max_len}")
        self.metrics_registry = metrics_registry \
            if metrics_registry is not None else MetricsRegistry()
        self.cache = CompileCache(metrics=self.metrics_registry)
        self.engine = DecodeEngine(self.cache, self.ladder,
                                   self.config.slots,
                                   self.config.prefill_rows,
                                   prefill_chunk=self.config.prefill_chunk)
        self._lock = threading.Lock()
        self._loops: Dict[str, DecodeLoop] = {}
        self._unloading: set = set()
        self._warm_caches: Dict[tuple, KVCache] = {}
        self._shut_down = False

    # ------------------------------------------------------ lifecycle
    def _new_cache(self, servable) -> KVCache:
        return KVCache.for_model(servable.model, self.config.slots,
                                 self.config.max_len, device=self.device)

    def load(self, name: str, model: torch.nn.Module, *,
             version: Optional[int] = None, activate: bool = True,
             warmup: bool = True) -> Servable:
        """Registry load + eager prefill/decode warmup.

        The version is registered inactive, its 2K programs are built
        and run once (``warmup=True``), and only then swapped in — a
        hot-swap under live traffic never serves a cold bucket, and
        in-flight generations keep decoding on the old version. The
        model must already live on the service's device."""
        dev = next(model.parameters()).device
        if dev.type != self.device.type or (
                self.device.index is not None and dev != self.device):
            raise ValueError(f"model is on {dev}, the service on "
                             f"{self.device}: build or move it there "
                             f"first")
        servable = self.registry.load(name, model, version=version,
                                      activate=False)
        if warmup:
            # warm into the cache the decode loop will ADOPT at this
            # version's first admission: one allocation per version
            kv = self._new_cache(servable)
            self.engine.warmup(servable, kv)
            with self._lock:
                # at most ONE stashed cache per name
                for k in [k for k in self._warm_caches if k[0] == name]:
                    del self._warm_caches[k]
                self._warm_caches[servable.key] = kv
        if activate:
            self.registry.swap(name, servable.version)
        return servable

    def swap(self, name: str, version: int) -> Servable:
        """Atomic hot-swap: generations already occupying slots finish
        on the version they prefilled with; later admissions decode
        ``version``."""
        return self.registry.swap(name, version)

    def unload(self, name: str, version: Optional[int] = None) -> None:
        """Unload a version (or the whole name, draining its decode
        loop) and release its programs. While a whole-name unload is in
        flight the name admits nothing."""
        loop = None
        if version is None:
            with self._lock:
                loop = self._loops.pop(name, None)
                self._unloading.add(name)
        try:
            if loop is not None:
                loop.shutdown(drain=True)
            for key in self.registry.unload(name, version):
                self.engine.drop(key)
                with self._lock:
                    self._warm_caches.pop(key, None)
        finally:
            if version is None:
                with self._lock:
                    self._unloading.discard(name)

    def shutdown(self, drain: bool = True) -> None:
        """Stop admission on every decode loop; with ``drain`` finish
        queued + live generations first, else fail them typed. Joins
        every loop's thread."""
        with self._lock:
            self._shut_down = True
            loops = list(self._loops.values())
        for loop in loops:
            loop.shutdown(drain=drain)

    # ------------------------------------------------------- generate
    def _loop(self, name: str) -> DecodeLoop:
        with self._lock:
            loop = self._loops.get(name)
            if loop is None:
                if self._shut_down:
                    raise RuntimeError("GenerationService is shut down")
                if name in self._unloading:
                    raise KeyError(f"{name!r} is being unloaded")
                self.registry.current(name)  # fail fast on unknown names
                loop = DecodeLoop(
                    name, self.registry, self.engine,
                    max_len=self.config.max_len,
                    eos_token=self.config.eos_token,
                    max_queue=self.config.max_queue,
                    default_max_new=self.config.max_new_tokens,
                    timeout_ms=self.config.timeout_ms,
                    metrics=self.metrics_registry,
                    cache_provider=self._cache_for)
                self._loops[name] = loop
        return loop

    def _cache_for(self, servable) -> KVCache:
        """The decode loop's cache source: adopt the buffers warmup
        already allocated for this version, else build fresh."""
        with self._lock:
            kv = self._warm_caches.pop(servable.key, None)
        return kv if kv is not None else self._new_cache(servable)

    def generate(self, name: str, prompt, *,
                 max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None, seed: int = 0,
                 timeout_ms: Optional[float] = None) -> TokenStream:
        """Submit one generation; returns a :class:`TokenStream`.
        ``temperature=0`` (default) is greedy; a positive temperature
        samples (optionally top-k-restricted) from the request's own
        seeded stream, so identical requests give identical tokens."""
        return self._loop(name).submit(
            np.asarray(prompt),
            max_new_tokens=max_new_tokens,
            sampling=SamplingParams(temperature=temperature,
                                    top_k=top_k, seed=seed),
            timeout_ms=timeout_ms)

    def preempt(self, name: str, stream: TokenStream,
                err: BaseException) -> Optional[str]:
        """Fail one of ``name``'s in-flight generations typed (see
        :meth:`DecodeLoop.preempt`)."""
        with self._lock:
            loop = self._loops.get(name)
        return None if loop is None else loop.preempt(stream, err)

    # -------------------------------------------------------- metrics
    def compile_count(self, name: str,
                      version: Optional[int] = None) -> int:
        """Programs built for ``name`` (one version, or all) — the
        quantity the ≤ 2K bound is asserted on."""
        versions = [version] if version is not None \
            else self.registry.versions(name)
        return sum(self.engine.compile_count(_KeyOnly(name, v))
                   for v in versions)

    def metrics(self, name: str) -> Dict[str, float]:
        """Point-in-time generation stats for one model name: request
        and token counts, prefill chunk calls, queue depth, live slots,
        cache occupancy, padding efficiency, TTFT and per-token-latency
        percentiles, and the program count."""
        labels = {"model": name}
        r = self.metrics_registry

        def count(metric):
            return int(r.counter(f"serving/generation/{metric}")
                       .value(**labels))

        out: Dict[str, float] = {
            "request_count": count("requests"),
            "rejected": count("rejected"),
            "timed_out": count("timed_out"),
            "tokens": count("tokens"),
            "finished": count("finished"),
            "worker_restarts": count("worker_restarts"),
            "prefill_chunks": count("prefill_chunks"),
            "decode_steps": r.histogram("serving/generation/token_ms")
            .count(**labels),
            "cache_occupancy": float(r.gauge(
                "serving/generation/cache_occupancy").value(**labels)),
            "padding_efficiency": float(r.gauge(
                "serving/generation/padding_efficiency").value(**labels)),
            "queue_depth": 0, "live_slots": 0,
        }
        with self._lock:
            loop = self._loops.get(name)
        if loop is not None:
            out["queue_depth"] = loop.queue_depth()
            out["live_slots"] = loop.live_slots()
        for metric in ("ttft_ms", "token_ms"):
            samples = r.histogram(f"serving/generation/{metric}") \
                .samples(**labels)
            for k, v in percentile_summary(samples, (50, 99)).items():
                out[f"{metric}_{k}"] = v
        out["compile_count"] = self.compile_count(name)
        return out


class _KeyOnly:
    """A (name, version) stand-in with the Servable ``key`` shape, for
    program-count lookups of non-current versions."""

    __slots__ = ("key",)

    def __init__(self, name: str, version: int):
        self.key = (name, version)

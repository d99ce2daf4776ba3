"""DecodeLoop — the continuous-batching decode loop (counterpart of
``bigdl_tpu.generation.loop``).

One thread per model name runs the generation loop: every step first
admits queued requests into whatever cache slots are free (a
padded-prompt prefill on the side, its K/V rows written straight into
the cache), then decodes one token for every live slot, then evicts
finished / EOS / max-token / deadline-expired slots. The batch never
drains to admit: short requests leave mid-flight and their slots refill
next step. Admission is bounded (``QueueFull``), deadlines fail typed
(``DeadlineExceeded``), and a crash of the loop fails every queued and
live stream with ``WorkerDied`` before the supervisor restarts it.

Hot-swap rides the registry: live slots are grouped by the servable
they prefilled on; a swap routes new admissions to the new version
while the old group keeps decoding until its slots drain, then its
cache is dropped.

Not ported yet: the prefix cache, chunked-prefill accounting, fault
points and per-request trace spans.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.generation.kv_cache import KVCache
from bigdl_tpu_torch.generation.sampling import Sampler, SamplingParams
from bigdl_tpu_torch.generation.stream import TokenStream
from bigdl_tpu_torch.serving.errors import (DeadlineExceeded, QueueFull,
                                            WorkerDied)
from bigdl_tpu_torch.telemetry import MetricsRegistry

__all__ = ["DecodeLoop", "register_generation_instruments"]


def register_generation_instruments(r: MetricsRegistry) -> Dict[str, object]:
    """Get-or-create every ``serving/generation/*`` instrument in
    ``r`` — the decode loop's whole metric surface."""
    return {
        "requests": r.counter(
            "serving/generation/requests", "generation requests admitted"),
        "rejected": r.counter(
            "serving/generation/rejected",
            "generation requests rejected at admission (QueueFull)"),
        "timed_out": r.counter(
            "serving/generation/timed_out",
            "generations failed past their deadline"),
        "tokens": r.counter(
            "serving/generation/tokens", "tokens generated"),
        "finished": r.counter(
            "serving/generation/finished", "generations finished cleanly"),
        "worker_restarts": r.counter(
            "serving/generation/worker_restarts",
            "decode-loop deaths survived by supervision"),
        "worker_failed": r.counter(
            "serving/generation/worker_failed",
            "generations failed with WorkerDied by a loop death"),
        "queue_depth": r.gauge(
            "serving/generation/queue_depth",
            "generation requests waiting for a cache slot"),
        "cache_occupancy": r.gauge(
            "serving/generation/cache_occupancy",
            "live KV-cache slot fraction"),
        "padding_efficiency": r.gauge(
            "serving/generation/padding_efficiency",
            "real cached tokens / (live slots x attended length) of the "
            "last decode step"),
        "ttft_ms": r.histogram(
            "serving/generation/ttft_ms",
            "submit -> first token latency (ms)"),
        "token_ms": r.histogram(
            "serving/generation/token_ms",
            "decode-step wall-clock per generated token (ms)"),
        "prefill_fill": r.histogram(
            "serving/generation/prefill_fill",
            "real rows / padded rows per prefill batch"),
        "preempted": r.counter(
            "serving/generation/preempted",
            "generations failed typed by preemption (their slots freed; "
            "partial tokens kept)"),
    }


class _Gen:
    """One in-flight generation (loop-private)."""

    __slots__ = ("prompt", "stream", "sampler", "max_new", "deadline",
                 "last", "produced", "slot")

    def __init__(self, prompt: np.ndarray, stream: TokenStream,
                 sampler: Sampler, max_new: int,
                 deadline: Optional[float]):
        self.prompt = prompt
        self.stream = stream
        self.sampler = sampler
        self.max_new = max_new
        self.deadline = deadline
        self.last: int = -1       # the newest sampled, not-yet-cached token
        self.produced: int = 0
        self.slot: int = -1


class _Group:
    """Live decode state pinned to ONE servable (a decode batch never
    mixes versions)."""

    __slots__ = ("servable", "kv", "gens")

    def __init__(self, servable, kv: KVCache):
        self.servable = servable
        self.kv = kv
        self.gens: Dict[int, _Gen] = {}


class DecodeLoop:
    """Continuous-batching generation loop for one model name (module
    docstring has the step anatomy). Created and owned by
    :class:`~bigdl_tpu_torch.generation.service.GenerationService`."""

    def __init__(self, name: str, registry, engine, *, max_len: int,
                 cache_provider: Callable[[object], KVCache],
                 eos_token: Optional[int] = None, max_queue: int = 256,
                 default_max_new: int = 64,
                 timeout_ms: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self._name = name
        self._registry = registry
        self._engine = engine
        self._max_len = max_len
        #: servable -> KVCache for a new group (the service hands over
        #: the cache its load-time warmup already allocated)
        self._cache_provider = cache_provider
        self._eos = eos_token
        self._max_queue = max_queue
        self._default_max_new = default_max_new
        self._timeout_ms = timeout_ms

        r = metrics if metrics is not None else MetricsRegistry()
        self.registry_metrics = r
        self._labels = {"model": name}
        inst = register_generation_instruments(r)
        self._c_requests = inst["requests"]
        self._c_rejected = inst["rejected"]
        self._c_timed_out = inst["timed_out"]
        self._c_tokens = inst["tokens"]
        self._c_finished = inst["finished"]
        self._c_worker_restarts = inst["worker_restarts"]
        self._c_worker_failed = inst["worker_failed"]
        self._g_depth = inst["queue_depth"]
        self._g_occupancy = inst["cache_occupancy"]
        self._g_padding = inst["padding_efficiency"]
        self._h_ttft = inst["ttft_ms"]
        self._h_token = inst["token_ms"]
        self._h_prefill_fill = inst["prefill_fill"]
        self._c_preempted = inst["preempted"]

        self._cond = threading.Condition()
        #: stream-identity -> typed error for live generations marked
        #: for preemption; the decode thread applies the mark at its next sweep
        self._preempt_marks: Dict[int, BaseException] = {}
        self._seq = itertools.count(1)
        self._queue: Deque[_Gen] = deque()
        self._groups: "OrderedDict[tuple, _Group]" = OrderedDict()
        self._stopping = False
        self._drain = True
        self._thread = threading.Thread(
            target=self._supervised, name=f"serving-decode-{name}",
            daemon=True)
        self._thread.start()

    # -------------------------------------------------------- submit
    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               timeout_ms: Optional[float] = None) -> TokenStream:
        """Enqueue one generation; returns its :class:`TokenStream`.

        Raises :class:`QueueFull` at the admission bound (a full KV
        cache only queues), and ValueError for prompts that cannot fit
        the cache (``len(prompt) >= max_len`` leaves no room for one
        generated token). ``max_new_tokens`` is capped to the cache room
        left after the prompt."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt needs >= 1 tokens")
        if prompt.shape[0] >= self._max_len:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens leaves no room to "
                f"generate in a max_len={self._max_len} cache")
        max_new = max_new_tokens if max_new_tokens is not None \
            else self._default_max_new
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        max_new = min(max_new, self._max_len - prompt.shape[0])
        sampling = (sampling or SamplingParams()).validate()
        timeout_ms = timeout_ms if timeout_ms is not None \
            else self._timeout_ms
        deadline = (time.monotonic() + timeout_ms / 1000.0
                    if timeout_ms is not None else None)
        stream = TokenStream(prompt.shape[0], max_new,
                             trace_id=f"{self._name}/gen-"
                                      f"{next(self._seq)}")
        gen = _Gen(prompt, stream, Sampler(sampling), max_new, deadline)
        with self._cond:
            if self._stopping:
                raise RuntimeError(
                    f"generation loop {self._name!r} is shut down")
            if len(self._queue) >= self._max_queue:
                self._c_rejected.inc(**self._labels)
                raise QueueFull(
                    f"{self._name}: generation queue at max depth "
                    f"{self._max_queue}")
            self._queue.append(gen)
            self._c_requests.inc(**self._labels)
            self._g_depth.set(len(self._queue), **self._labels)
            self._cond.notify_all()
        return stream

    def preempt(self, stream: TokenStream, err: BaseException
                ) -> Optional[str]:
        """Fail one in-flight generation *typed* so its capacity goes
        to another request. A queued generation fails now; a live one
        is marked and failed by the decode thread at its next sweep (the
        thread that owns the cache). ``err.tokens`` carries the partial
        tokens. Returns ``"queued"``/``"live"``, or None when the stream
        is not held here."""
        with self._cond:
            for g in self._queue:
                if g.stream is stream:
                    self._queue.remove(g)
                    self._g_depth.set(len(self._queue), **self._labels)
                    self._c_preempted.inc(**self._labels)
                    err.tokens = stream.tokens()
                    g.stream._fail(err)
                    return "queued"
            for group in self._groups.values():
                for g in group.gens.values():
                    if g.stream is stream:
                        self._preempt_marks[id(stream)] = err
                        self._cond.notify_all()
                        return "live"
        return None

    def queue_depth(self) -> int:
        """Requests waiting for a cache slot."""
        with self._cond:
            return len(self._queue)

    def live_slots(self) -> int:
        """Generations currently occupying cache slots (all
        versions)."""
        with self._cond:
            return sum(len(g.gens) for g in self._groups.values())

    # ----------------------------------------------- the decode thread
    def _has_live_locked(self) -> bool:
        return any(g.gens for g in self._groups.values())

    def _supervised(self) -> None:
        """Run ``_loop`` under supervision: a crash in the decode
        machinery fails every in-flight generation and everything queued
        with a typed :class:`WorkerDied` — never a silent hang — then
        restarts the loop with fresh caches."""
        while True:
            try:
                self._loop()
                return  # clean shutdown
            except BaseException as e:  # noqa: BLE001 — supervision
                with self._cond:
                    died: List[_Gen] = list(self._queue)
                    self._queue.clear()
                    for group in self._groups.values():
                        died.extend(group.gens.values())
                    # the step may have died mid-write: the caches are
                    # unrecoverable state — rebuild on demand
                    self._groups.clear()
                    self._preempt_marks.clear()
                    restart = not self._stopping
                    if restart:
                        self._c_worker_restarts.inc(**self._labels)
                    self._c_worker_failed.inc(len(died), **self._labels)
                    self._g_depth.set(0, **self._labels)
                    self._g_occupancy.set(0.0, **self._labels)
                    self._cond.notify_all()
                err = WorkerDied(
                    f"decode loop {self._name!r} died: "
                    f"{type(e).__name__}: {e}")
                err.__cause__ = e
                for g in died:
                    g.stream._fail(err)
                if not restart:
                    return
                if not isinstance(e, Exception):
                    raise  # interpreter exit / interrupt: stop serving

    def _loop(self) -> None:
        while True:
            with self._cond:
                while (not self._queue and not self._has_live_locked()
                       and not self._stopping):
                    # going idle: drop drained groups now, so a stale
                    # post-swap cache does not stay pinned on the device
                    self._groups.clear()
                    self._cond.wait()
                if self._stopping:
                    if not self._drain:
                        self._abort_locked()
                        return
                    if not self._queue and not self._has_live_locked():
                        return
                self._expire_queued_locked(time.monotonic())
            self._admit()
            self._decode_step()

    def _abort_locked(self) -> None:
        """drain=False shutdown: fail queued AND live promptly (typed),
        free every slot."""
        err = RuntimeError(f"generation loop {self._name!r} shut down")
        doomed = list(self._queue)
        self._queue.clear()
        for group in self._groups.values():
            doomed.extend(group.gens.values())
        self._groups.clear()
        self._preempt_marks.clear()
        self._g_depth.set(0, **self._labels)
        self._g_occupancy.set(0.0, **self._labels)
        for g in doomed:
            g.stream._fail(err)

    def _expire_queued_locked(self, now: float) -> None:
        if not self._queue:
            return
        keep: Deque[_Gen] = deque()
        for g in self._queue:
            if g.deadline is not None and now > g.deadline:
                self._c_timed_out.inc(**self._labels)
                g.stream._fail(DeadlineExceeded(
                    f"{self._name}: generation waited past its deadline "
                    "in the admission queue"))
            else:
                keep.append(g)
        if len(keep) != len(self._queue):
            self._queue = keep
            self._g_depth.set(len(self._queue), **self._labels)

    # ------------------------------------------------------ admission
    def _admit(self) -> None:
        """Admit queued requests into free slots of the CURRENT
        version's cache — every step, so admission never waits for the
        batch to drain."""
        with self._cond:
            if not self._queue:
                return
            servable = self._registry.current(self._name)
            group = self._groups.get(servable.key)
            if group is None:
                group = _Group(servable, self._cache_provider(servable))
                self._groups[servable.key] = group
            n = min(group.kv.allocator.free_count,
                    self._engine.prefill_rows, len(self._queue))
            if n == 0:
                return  # a full cache queues; eviction frees slots
            gens = [self._queue.popleft() for _ in range(n)]
            self._g_depth.set(len(self._queue), **self._labels)
            # enter the group BEFORE the prefill: a prefill that raises
            # must find these gens so the supervisor fails them typed
            for g in gens:
                g.slot = group.kv.allocator.alloc()
                group.gens[g.slot] = g
        logits, _ = self._engine.prefill(
            servable, group.kv, [g.prompt for g in gens],
            [g.slot for g in gens])
        self._h_prefill_fill.observe(
            len(gens) / self._engine.prefill_rows, **self._labels)
        for i, g in enumerate(gens):
            self._emit(group, g, g.sampler.sample(logits[i]))
        self._g_occupancy.set(group.kv.occupancy(), **self._labels)

    # ---------------------------------------------------- decode step
    def _decode_step(self) -> None:
        with self._cond:
            # snapshot under the lock: submit/_admit mutate the group
            # map concurrently with this sweep
            groups = list(self._groups.items())
        for key, group in groups:
            if not group.gens:
                # an old version's slots drained after a hot-swap (or
                # traffic paused): release its cache
                with self._cond:
                    if not group.gens:
                        self._groups.pop(key, None)
                continue
            kv = group.kv
            live = sorted(group.gens)
            tokens = np.zeros((kv.slots,), np.int32)
            positions = np.zeros((kv.slots,), np.int32)
            active = np.zeros((kv.slots,), bool)
            for slot in live:
                tokens[slot] = group.gens[slot].last
                # kv.lengths IS the ragged bound: the decode step's
                # kernel reads exactly lengths[slot] + 1 cache rows
                positions[slot] = kv.lengths[slot]
                active[slot] = True
            t0 = time.monotonic()
            logits, attend_len = self._engine.decode(
                group.servable, kv, tokens, positions, active)
            now = time.monotonic()
            self._h_token.observe((now - t0) * 1000.0 / len(live),
                                  **self._labels)
            real = int(kv.lengths[live].sum()) + len(live)
            self._g_padding.set(real / (len(live) * attend_len),
                                **self._labels)
            for slot in live:
                g = group.gens[slot]
                kv.lengths[slot] += 1  # g.last's K/V landed this step
                with self._cond:
                    perr = self._preempt_marks.pop(id(g.stream), None)
                if perr is not None:
                    perr.tokens = g.stream.tokens()
                    self._c_preempted.inc(**self._labels)
                    g.stream._fail(perr)
                    self._release(group, g)
                    continue
                if g.deadline is not None and now > g.deadline:
                    self._c_timed_out.inc(**self._labels)
                    g.stream._fail(DeadlineExceeded(
                        f"{self._name}: generation passed its deadline "
                        f"after {g.produced} tokens"))
                    self._release(group, g)
                    continue
                self._emit(group, g, g.sampler.sample(logits[slot]))
            self._g_occupancy.set(group.kv.occupancy(), **self._labels)

    def _emit(self, group: _Group, g: _Gen, token: int) -> None:
        """Deliver one sampled token and apply the eviction rules
        (EOS / max_new_tokens / cache end)."""
        first = g.produced == 0
        g.last = token
        g.produced += 1
        g.stream._push(token)
        self._c_tokens.inc(**self._labels)
        if first and g.stream.ttft_ms is not None:
            self._h_ttft.observe(g.stream.ttft_ms, **self._labels)
        if self._eos is not None and token == self._eos:
            self._finish(group, g, "eos")
        elif g.produced >= g.max_new:
            self._finish(group, g, "max_tokens")
        elif g.prompt.shape[0] + g.produced >= self._max_len:
            # defensive: the submit-time cap makes this unreachable
            self._finish(group, g, "max_len")

    def _finish(self, group: _Group, g: _Gen, reason: str) -> None:
        self._c_finished.inc(**self._labels)
        g.stream._finish(reason)
        self._release(group, g)

    def _release(self, group: _Group, g: _Gen) -> None:
        group.gens.pop(g.slot, None)
        group.kv.lengths[g.slot] = 0
        group.kv.allocator.free(g.slot)
        with self._cond:
            self._preempt_marks.pop(id(g.stream), None)

    # ------------------------------------------------------ shutdown
    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop admission; with ``drain`` run queued + live generations
        to completion, else fail them promptly (typed); then join the
        decode thread (``timeout`` seconds at most)."""
        with self._cond:
            self._stopping = True
            self._drain = drain and self._drain
            self._cond.notify_all()
        self._thread.join(timeout)

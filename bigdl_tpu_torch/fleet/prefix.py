"""Prefix/KV reuse: skip prefill for prompts the service has seen before
(counterpart of ``bigdl_tpu.fleet.prefix``).

Prompt traffic repeats itself: the same system prompt, the same
few-shot template. The K/V rows a prefill computes for a prefix are a
deterministic function of (model version, prefix tokens), so this
module keeps them as **committed KV blocks**:

- :meth:`PrefixCache.insert` stores, per ``(servable version, prompt)``
  key, the prompt's K/V rows (a device copy taken out of the slot the
  prefill just wrote, padded to the prompt's ladder rung so seeding
  shapes stay bucketed) and the prefill's first-token logits row;
- :meth:`PrefixCache.lookup` answers an admission with the entry; the
  decode loop **seeds** the slot's cache rows by device copy
  (:meth:`~PrefixCache.seed`) and goes straight to decode;
- :meth:`PrefixCache.lookup_prefix` is the long-context PARTIAL probe:
  under chunked prefill the loop also stores each new prompt's first
  chunk, so a prompt sharing a cached chunk-boundary prefix seeds the
  covered rows and the engine prefills only the rest (``start=``);
- the cache is **reference-counted and capacity-bounded**: a lookup
  pins its entry until the reading slot is released, eviction is LRU
  over unpinned entries only, and an insert that cannot fit after
  evicting every unpinned entry is refused rather than growing past
  ``max_bytes``.

The stored rows are a copy of the bytes the slot's own prefill wrote,
and rows past the prompt length are never attended (the length-masked
attention), so a seeded slot's greedy stream equals the cold stream.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from bigdl_tpu_torch import telemetry

__all__ = ["PrefixCache", "PrefixEntry", "register_prefix_instruments"]


def register_prefix_instruments(r) -> Dict[str, object]:
    """Get-or-create the ``fleet/prefix/*`` instruments in registry
    ``r``."""
    return {
        "hits": r.counter(
            "fleet/prefix/hits", "admissions seeded from a cached prefix "
            "(prefill skipped entirely)"),
        "misses": r.counter(
            "fleet/prefix/misses", "admissions that ran a cold prefill"),
        "partial_hits": r.counter(
            "fleet/prefix/partial_hits",
            "admissions seeded from a chunk-boundary prefix (only the "
            "remaining chunks prefilled)"),
        "inserts": r.counter(
            "fleet/prefix/inserts", "prefix entries committed to the cache"),
        "evictions": r.counter(
            "fleet/prefix/evictions",
            "refcount-zero prefix entries evicted (LRU) to fit an insert"),
        "bytes": r.gauge(
            "fleet/prefix/bytes", "device bytes held by cached KV blocks"),
        "entries": r.gauge(
            "fleet/prefix/entries", "prefix entries resident in the cache"),
    }


class PrefixEntry:
    """One cached prefix: committed K/V blocks and first-token logits.

    ``k``/``v`` are device tensors ``[layers, heads, rung, head_dim]``
    (``rung`` the prompt's ladder bucket), ``length`` the real prefix
    length, ``logits`` the host ``[V]`` first-token logits row — or
    ``None`` for a chunk-BOUNDARY entry, whose tokens end mid-prompt;
    such entries serve only :meth:`PrefixCache.lookup_prefix`. ``refs``
    counts live readers; the cache never evicts an entry with
    ``refs > 0``. ``nbytes`` counts ``k``, ``v`` and ``logits``."""

    __slots__ = ("key", "version_key", "length", "rung", "k", "v",
                 "logits", "nbytes", "refs", "tick", "doomed")

    def __init__(self, key, version_key, length, rung, k, v, logits):
        self.key = key
        self.version_key = version_key
        self.length = int(length)
        self.rung = int(rung)
        self.k = k
        self.v = v
        self.logits = None if logits is None else np.asarray(logits)
        self.nbytes = (k.numel() * k.element_size()
                       + v.numel() * v.element_size()
                       + (0 if self.logits is None
                          else self.logits.nbytes))
        self.refs = 0
        self.tick = 0       # LRU clock (deterministic, not wall time)
        self.doomed = False  # version unloaded while pinned: drop at 0


class PrefixCache:
    """Reference-counted, capacity-bounded LRU cache of committed KV
    blocks (module docstring has the contract). Thread-safe: the decode
    loops of several models call ``lookup``/``insert``/``release``
    concurrently."""

    def __init__(self, max_bytes: int, metrics=None):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self._bytes = 0
        self._clock = itertools.count(1)
        r = metrics if metrics is not None else telemetry.REGISTRY
        inst = register_prefix_instruments(r)
        self._c_hits = inst["hits"]
        self._c_misses = inst["misses"]
        self._c_partial_hits = inst["partial_hits"]
        self._c_inserts = inst["inserts"]
        self._c_evictions = inst["evictions"]
        self._g_bytes = inst["bytes"]
        self._g_entries = inst["entries"]

    # ------------------------------------------------------------ keys
    @staticmethod
    def key_for(version_key, tokens) -> str:
        """The cache key: a digest over the servable version AND the
        prefix's int32 token bytes (the JAX package's key, digit for
        digit): K/V bytes are never shared across versions."""
        h = hashlib.sha256(repr(tuple(version_key)).encode())
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.hexdigest()

    # ---------------------------------------------------------- lookup
    def lookup(self, version_key, tokens, **labels) -> Optional[PrefixEntry]:
        """The admission-time probe: a full-prefix hit returns the entry
        PINNED (the caller must :meth:`release` it when the reading slot
        frees); a miss returns None. Counts ``fleet/prefix/hits`` /
        ``misses``."""
        entry = self._probe(self.key_for(version_key, tokens), full=True)
        if entry is None:
            self._c_misses.inc(**labels)
            return None
        self._c_hits.inc(**labels)
        return entry

    def _probe(self, key: str, full: bool) -> Optional[PrefixEntry]:
        """One pinned probe. ``full`` probes skip logits-less
        chunk-boundary entries (they cannot give the first token)."""
        with self._lock:
            entry = self._entries.get(key)
            # the verdict is taken INSIDE the lock: a concurrent
            # drop_version may doom the entry right after the pin
            hit = (entry is not None and not entry.doomed
                   and not (full and entry.logits is None))
            if hit:
                entry.refs += 1
                entry.tick = next(self._clock)
                self._entries.move_to_end(key)
        return entry if hit else None

    def lookup_prefix(self, version_key, tokens, chunk: int, **labels):
        """The long-context partial probe: the LONGEST cached prefix of
        ``tokens`` ending on a ``chunk`` boundary strictly inside the
        prompt, as a pinned ``(entry, boundary)`` pair — the loop seeds
        the covered rows and prefills from ``boundary`` on. None when
        no boundary prefix is cached. Counts
        ``fleet/prefix/partial_hits``."""
        n = len(tokens)
        for m in range((n - 1) // chunk, 0, -1):
            entry = self._probe(
                self.key_for(version_key, tokens[:m * chunk]), full=False)
            if entry is not None:
                self._c_partial_hits.inc(**labels)
                return entry, m * chunk
        return None

    def release(self, entry: PrefixEntry) -> None:
        """Unpin one reader. A doomed entry (its version unloaded while
        pinned) is dropped once its last reader lets go."""
        with self._lock:
            if entry.refs < 1:
                raise RuntimeError(
                    f"prefix entry {entry.key[:8]} over-released")
            entry.refs -= 1
            if entry.doomed and entry.refs == 0 \
                    and entry.key in self._entries:
                self._drop_locked(entry.key)

    # ---------------------------------------------------------- insert
    def insert(self, version_key, tokens, k_rows, v_rows, logits,
               **labels) -> Optional[PrefixEntry]:
        """Commit one prefix's KV blocks (copies the caller took out of
        the freshly prefilled slot, :meth:`extract`) and first-token
        logits (``None`` for a chunk-boundary entry). Evicts LRU unpinned
        entries until the new one fits; refused (None) when even that
        cannot make room — the cache never exceeds ``max_bytes`` and
        never frees blocks a live slot still reads."""
        key = self.key_for(version_key, tokens)
        rung = int(k_rows.shape[2])
        entry = PrefixEntry(key, tuple(version_key), len(tokens), rung,
                            k_rows, v_rows, logits)
        evicted, committed = 0, None
        with self._lock:
            if key in self._entries:
                # a concurrent admission already committed this prefix
                self._entries[key].tick = next(self._clock)
                self._entries.move_to_end(key)
                return self._entries[key]
            if entry.nbytes <= self.max_bytes:
                while self._bytes + entry.nbytes > self.max_bytes:
                    victim = next((k for k, e in self._entries.items()
                                   if e.refs == 0), None)
                    if victim is None:
                        break  # every resident entry is pinned: refuse
                    self._drop_locked(victim)
                    evicted += 1
                if self._bytes + entry.nbytes <= self.max_bytes:
                    entry.tick = next(self._clock)
                    self._entries[key] = entry
                    self._bytes += entry.nbytes
                    self._g_bytes.set(self._bytes)
                    self._g_entries.set(len(self._entries))
                    committed = entry
        if evicted:
            self._c_evictions.inc(evicted, **labels)
        if committed is not None:
            self._c_inserts.inc(**labels)
        return committed

    def _drop_locked(self, key: str) -> None:
        entry = self._entries.pop(key)
        self._bytes -= entry.nbytes
        self._g_bytes.set(self._bytes)
        self._g_entries.set(len(self._entries))

    # --------------------------------------------------------- version
    def drop_version(self, version_key) -> int:
        """Drop every entry of an unloaded servable version. Pinned
        entries are doomed instead (their blocks stay valid for the
        slots still reading them) and fall out at the last
        :meth:`release`. Returns how many entries dropped now."""
        vk = tuple(version_key)
        dropped = 0
        with self._lock:
            for key in [k for k, e in self._entries.items()
                        if e.version_key == vk]:
                entry = self._entries[key]
                if entry.refs > 0:
                    entry.doomed = True
                else:
                    self._drop_locked(key)
                    dropped += 1
        return dropped

    # ---------------------------------------------------- seed/extract
    @staticmethod
    def extract(kv, slot: int, rung: int):
        """COPY the committed K/V blocks out of a freshly prefilled
        slot: ``[layers, heads, rung, head_dim]`` for K and V. A copy,
        not a view: the slot's later decode writes must not reach the
        entry. Rows past the prompt length ride along (the rung pads
        them) but are never attended."""
        return (kv.k[:, slot, :, :rung, :].clone(),
                kv.v[:, slot, :, :rung, :].clone())

    @staticmethod
    def seed(kv, slot: int, entry: PrefixEntry) -> None:
        """Seed one slot from a cached entry by an in-place device copy
        on the current stream: the slot's first ``rung`` cache rows
        become the committed blocks and ``lengths[slot]`` the prefix
        length, the state a cold prefill would have left."""
        kv.k[:, slot, :, :entry.rung, :].copy_(entry.k)
        kv.v[:, slot, :, :entry.rung, :].copy_(entry.v)
        kv.lengths[slot] = entry.length

    # ------------------------------------------------------- introspect
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def nbytes(self) -> int:
        """Device bytes currently held by cached blocks."""
        with self._lock:
            return self._bytes

    def pinned(self) -> int:
        """Entries with live readers (not evictable right now)."""
        with self._lock:
            return sum(1 for e in self._entries.values() if e.refs > 0)

    def stats(self) -> Dict[str, float]:
        """Point-in-time cache stats (host view)."""
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "pinned": sum(1 for e in self._entries.values()
                                  if e.refs > 0),
                    "max_bytes": self.max_bytes}

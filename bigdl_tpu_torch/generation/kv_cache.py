"""Preallocated KV cache + host-side slot accounting (counterpart of
``bigdl_tpu.generation.kv_cache``).

One allocation per model version: ``[layers, slots, heads, max_len,
head_dim]`` K and V tensors on the device, an explicit host ``lengths``
vector, and a host alloc/free bitmap. Requests occupy slots, so
continuous batching never reshapes or reallocates device memory. The
JAX package threads the arrays through donated programs; here the
programs write the tensors in place.
"""
from __future__ import annotations

from typing import FrozenSet, List, Optional, Union

import numpy as np
import torch

from bigdl_tpu_torch.utils.engine import default_dtype, resolve_device

__all__ = ["KVCache", "SlotAllocator"]


class SlotAllocator:
    """Host-side alloc/free bitmap over a cache's request slots.

    Single-owner accounting (the decode loop's thread): ``alloc``
    hands out the lowest free slot, ``free`` returns it, and both raise
    on a double assignment instead of letting two generations share
    cache rows."""

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"need >= 1 slots, got {slots}")
        self.slots = slots
        self._free: List[int] = list(range(slots - 1, -1, -1))
        self._live: set = set()

    @property
    def free_count(self) -> int:
        """Slots currently available for admission."""
        return len(self._free)

    @property
    def live(self) -> FrozenSet[int]:
        """The slots currently owned by in-flight generations."""
        return frozenset(self._live)

    def alloc(self) -> int:
        """Claim the lowest free slot; raises when the cache is full."""
        if not self._free:
            raise RuntimeError("KV cache is full (no free slots)")
        slot = self._free.pop()
        if slot in self._live:
            raise RuntimeError(
                f"slot {slot} double-assigned (allocator corrupted)")
        self._live.add(slot)
        return slot

    def free(self, slot: int) -> None:
        """Return a slot to the pool; freeing a slot that is not live
        raises."""
        if slot not in self._live:
            raise RuntimeError(
                f"freeing slot {slot} which is not live "
                f"(live={sorted(self._live)})")
        self._live.discard(slot)
        self._free.append(slot)


class KVCache:
    """One model version's preallocated decode cache.

    ``k``/``v`` are device tensors ``[layers, slots, heads, max_len,
    head_dim]`` written in place by every prefill/decode program;
    ``lengths`` is the host int32 vector of per-slot sequence lengths
    (= the next write position) and ``allocator`` the slot bitmap. A
    freed slot's rows are not zeroed: every position a later occupant
    can attend is written (by its prefill, or by the decode step that
    produces it) before the length mask exposes it."""

    def __init__(self, layers: int, slots: int, heads: int, max_len: int,
                 head_dim: int,
                 device: Optional[Union[str, torch.device]] = None):
        self.layers = layers
        self.slots = slots
        self.heads = heads
        self.max_len = max_len
        self.head_dim = head_dim
        self.dtype = default_dtype()
        self.device = resolve_device(device)
        shape = (layers, slots, heads, max_len, head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.lengths = np.zeros((slots,), np.int32)
        self.allocator = SlotAllocator(slots)

    @classmethod
    def for_model(cls, model, slots: int, max_len: int,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> "KVCache":
        """Size a cache from a decoder model's declared geometry
        (``num_layers``, ``num_heads``, ``head_dim`` or
        ``hidden_size``), on the model's device unless ``device`` says
        otherwise."""
        heads = int(model.num_heads)
        head_dim = int(getattr(model, "head_dim",
                               model.hidden_size // heads))
        if max_len > int(getattr(model, "max_len", max_len)):
            raise ValueError(
                f"cache max_len={max_len} exceeds the model's positional "
                f"table ({model.max_len})")
        if device is None:
            device = next(model.parameters()).device
        return cls(int(model.num_layers), slots, heads, max_len, head_dim,
                   device)

    def occupancy(self) -> float:
        """Live-slot fraction (the ``cache_occupancy`` gauge)."""
        return 1.0 - self.allocator.free_count / self.slots

    def __repr__(self) -> str:
        return (f"KVCache(L={self.layers} slots={self.slots} "
                f"H={self.heads} T={self.max_len} D={self.head_dim} "
                f"{self.dtype}, {self.device}, "
                f"live={len(self.allocator.live)})")

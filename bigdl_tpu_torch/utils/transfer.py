"""Host-to-card copy sizing (counterpart of ``bigdl_tpu.utils.transfer``).

:func:`probe_device_put_chunk` times copies of ascending sizes from a
pinned host buffer to the device, once per process, and returns the
largest piece that stays near the best rate seen: the chunk every
piecewise staging path (the device cache's staged construction, shard
rotation) copies at. A copy into a tensor allocated beforehand is timed
to its completion: CUDA events on the card, the host clock on the CPU.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["probe_device_put_chunk", "probe_rates"]

#: the probe's choice in this process, by device (the JAX package keeps
#: one per process; the port may run a card and the CPU side by side)
_cached_chunk: Dict[str, int] = {}
#: ``{bytes: bytes/s}`` of the last probe, by device (what it measured)
probe_rates: Dict[str, Dict[int, float]] = {}


def _timed_copy(src: torch.Tensor, device: torch.device) -> float:
    """Seconds of one completed copy of ``src`` into a tensor allocated
    on ``device`` beforehand (the allocation is not timed)."""
    dst = torch.empty_like(src, device=device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    dst.copy_(src)
    return time.perf_counter() - t0


def probe_device_put_chunk(max_mb: int = 96, *, drop_ratio: float = 0.5,
                           device="cuda") -> int:
    """Time copies of 4, 8, ... ``max_mb`` MB and return the largest
    size (bytes) whose rate holds at least ``drop_ratio`` times the best
    seen; the ascending walk stops at the first size below that, so at
    most one slow copy is issued. The result is kept per process and
    device; ``BENCH_CHUNK_MB`` (MB, may be fractional) answers without a
    probe. ``device`` is the card unless the caller asks for ``"cpu"``;
    without CUDA a card probe raises."""
    device = torch.device(device)
    key = str(device)
    if key in _cached_chunk:
        return _cached_chunk[key]
    env = os.environ.get("BENCH_CHUNK_MB")
    if env:
        _cached_chunk[key] = int(float(env) * (1 << 20))
        return _cached_chunk[key]
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "probe_device_put_chunk: CUDA is not available; pass "
            "device='cpu' to time host copies")
    pinned = device.type == "cuda"
    rates: Dict[int, float] = {}
    best_bps = 0.0
    chosen: Optional[int] = None
    mb = 4
    while mb <= max_mb:
        # a random payload, as the JAX package's probe sends
        arr = np.random.RandomState(mb).randint(0, 256, mb << 20,
                                                dtype=np.uint8)
        src = torch.from_numpy(arr)
        if pinned:
            src = src.pin_memory()
        _timed_copy(src[:1 << 20], device)      # first-touch out of the way
        bps = arr.nbytes / max(_timed_copy(src, device), 1e-9)
        rates[arr.nbytes] = bps
        if bps >= best_bps:
            best_bps = bps
            chosen = arr.nbytes
        elif bps < drop_ratio * best_bps:
            break                   # over the cliff: no larger sizes
        else:
            chosen = arr.nbytes     # slower but acceptable: keep growing
        mb *= 2
    if chosen is None:
        chosen = 4 << 20
    probe_rates[key] = rates
    _cached_chunk[key] = chosen
    return chosen

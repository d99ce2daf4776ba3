"""The copy to the card and window stacking (counterpart of
``bigdl_tpu.dataset.prefetch``).

:func:`device_prefetch` stages MiniBatches onto the card ``size`` steps
ahead of the consumer, on a thread of its own: each batch is copied
into a pinned host buffer (a ring per batch signature, so no batch
allocates pinned memory, and a buffer is not written again until the
copy that read it has completed), then to the card with
``copy_(non_blocking=True)`` on a side CUDA stream; the consumer's
stream waits on the copy's event and every staged tensor is
``record_stream``-ed onto it. No step synchronizes the card.

``stack_windows`` groups ``k`` consecutive equal-shaped MiniBatches into
one ``[k, ...]`` stacked MiniBatch: the buffer layout one window of
``k`` train steps reads (``Optimizer.set_steps_per_sync``, whose
CUDA-graph window copies it into its static inputs). The windowed
Optimizer groups inline — it must also flush windows at trigger
boundaries — with the same unit, ``stack_minibatches`` /
``batch_signature``. A window staged to the card comes as a
:class:`StackedWindow`, which the windowed Optimizer copies device to
device into its graph's inputs. (A device-cached dataset,
``dataset.device_dataset``, needs no staging: its batches are made on
the card.)
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List

import numpy as np
import torch

from bigdl_tpu_torch import faults, telemetry
from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["StackedWindow", "WindowRow", "batch_signature",
           "device_prefetch", "stack_minibatches", "stack_windows"]

# the feed's instruments: how deep the staged queue runs (is the card
# fed?), how long the stager takes to pull and stage a batch, and how
# long the consumer waits for one (the feed's bottleneck number)
_QUEUE_DEPTH = telemetry.gauge("data/prefetch/queue_depth",
                               "staged device batches waiting")
_STAGE_S = telemetry.histogram("data/prefetch/stage_s",
                               "seconds to pull + stage one batch")
_FETCH_WAIT_S = telemetry.histogram(
    "data/prefetch/fetch_wait_s",
    "seconds the consumer blocked waiting for a staged batch")
_STAGED = telemetry.counter("data/prefetch/staged_batches",
                            "batches staged to device")


def _array(x):
    """A host leaf as numpy (a CPU tensor through ``.numpy()``)."""
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


def _stack_leaves(parts):
    """Stack matching MiniBatch leaves along a new leading axis, keeping
    list/tuple input structure; None targets stay None."""
    def stk(*leaves):
        if any(v is None for v in leaves):
            if not all(v is None for v in leaves):
                raise ValueError(
                    "cannot window-stack batches that mix None and "
                    "non-None targets")
            return None
        if isinstance(leaves[0], (list, tuple)):
            return type(leaves[0])(
                stk(*grp) for grp in zip(*leaves))
        return np.stack([_array(v) for v in leaves])
    return stk(*parts)


def stack_windows(it: Iterator[MiniBatch], k: int) -> Iterator[MiniBatch]:
    """Group ``k`` consecutive MiniBatches into one stacked MiniBatch
    whose every leaf gains a leading window axis of length ``k``.

    All ``k`` members of a window must agree in shape; a shape change
    (a short final batch) closes the current window early, and the tail
    comes out as a shorter window. Each distinct window length captures
    its own graph downstream."""
    if k < 1:
        raise ValueError(f"window size must be >= 1, got {k}")
    pend: List[MiniBatch] = []
    sig = None

    def flush():
        nonlocal sig
        if not pend:
            return None
        out = stack_minibatches(pend)
        pend.clear()
        sig = None
        return out

    for b in it:
        s = batch_signature(b)
        # the flush after an append keeps pend below k here; only a shape
        # change closes a window early
        if pend and s != sig:
            yield flush()
        if not pend:
            sig = s
        pend.append(b)
        if len(pend) >= k:
            yield flush()
    tail = flush()
    if tail is not None:
        yield tail


def stack_minibatches(batches) -> MiniBatch:
    """Stack equal-shaped MiniBatches into one windowed MiniBatch with a
    leading axis of length ``len(batches)``."""
    return MiniBatch(_stack_leaves([b.input for b in batches]),
                     _stack_leaves([b.target for b in batches]))


def batch_signature(batch: MiniBatch):
    """Nested ``(shape, dtype)`` signature: two batches stack iff equal.
    Dtypes are numpy's names, as the JAX package records them (torch's
    names without the prefix are numpy's; a tensor on the card is read
    where it lies)."""
    def leaf(x):
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return tuple(leaf(e) for e in x)
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype).removeprefix("torch."))
        a = _array(x)
        return (a.shape, str(a.dtype))
    return (leaf(batch.input), leaf(batch.target))


def _row(x, i):
    if isinstance(x, (list, tuple)):
        return type(x)(_row(e, i) for e in x)
    return None if x is None else x[i]


def _first_leaf(x):
    return _first_leaf(x[0]) if isinstance(x, (list, tuple)) else x


class StackedWindow(MiniBatch):
    """``K`` MiniBatches stacked on a new leading axis (``[K, B, ...]``
    leaves), as :func:`~bigdl_tpu_torch.datapipe.stage_windows` stages
    them; ``size()`` counts all ``K * B`` rows."""

    def steps(self) -> int:
        return _first_leaf(self.input).shape[0]

    def size(self) -> int:
        leaf = _first_leaf(self.input)
        return leaf.shape[0] * leaf.shape[1]

    def rows(self, lo: int, hi: int) -> "StackedWindow":
        """Steps ``[lo, hi)`` as a window (views)."""
        sl = slice(lo, hi)
        return StackedWindow(_row(self.input, sl), _row(self.target, sl))

    def split(self) -> List["WindowRow"]:
        """The window's steps as MiniBatches, in order."""
        return [WindowRow(self, i) for i in range(self.steps())]


class WindowRow(MiniBatch):
    """Step ``index`` of a :class:`StackedWindow` (views of its
    leaves)."""

    def __init__(self, window: StackedWindow, index: int):
        super().__init__(_row(window.input, index),
                         _row(window.target, index))
        self.window = window
        self.index = index


class _CudaStager:
    """The staging thread's copies: host leaf -> pinned ring buffer ->
    card, on a side stream, one event a batch."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.depth = depth
        self.stream = torch.cuda.Stream(device)
        #: batch signature -> slots, oldest first; a slot is [pinned
        #: leaves, the event of the copy that last read them]
        self.rings = {}

    def _pinned(self, x):
        if isinstance(x, (list, tuple)):
            return [self._pinned(e) for e in x]
        if x is None:
            return None
        a = torch.as_tensor(x)
        return torch.empty(a.shape, dtype=a.dtype, pin_memory=True)

    def _copy(self, x, pinned):
        if isinstance(x, (list, tuple)):
            return type(x)(self._copy(e, p) for e, p in zip(x, pinned))
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            pinned.copy_(x)
        elif isinstance(x, np.ndarray):
            np.copyto(pinned.numpy(), x)
        else:
            raise TypeError(f"device_prefetch stages dense arrays and "
                            f"tensors, not {type(x).__name__}")
        dev = torch.empty(pinned.shape, dtype=pinned.dtype,
                          device=self.device)
        dev.copy_(pinned, non_blocking=True)
        return dev

    def stage(self, batch: MiniBatch):
        """``(the batch on the card, the event its copy recorded)``."""
        sig = batch_signature(batch)
        ring = self.rings.setdefault(sig, [])
        if len(ring) < self.depth:
            slot = [[self._pinned(batch.input), self._pinned(batch.target)],
                    None]
        else:
            slot = ring.pop(0)
            # the copy that last read this buffer must be done with it
            slot[1].synchronize()
        ring.append(slot)
        with torch.cuda.stream(self.stream):
            inp = self._copy(batch.input, slot[0][0])
            tgt = self._copy(batch.target, slot[0][1])
            event = torch.cuda.Event()
            event.record(self.stream)
        slot[1] = event
        return type(batch)(inp, tgt), event


def _tensors(x):
    if isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, torch.Tensor):
        yield x


class _PrefetchHandle:
    """Close protocol between the consumer generator and its stager:
    signal stop, drain what was queued (so a blocked ``put`` wakes up),
    join the thread. The join is bounded: a stager blocked inside
    ``next(it)`` on a slow upstream cannot be interrupted, and is left
    to end after its current pull."""

    def __init__(self, q: queue.Queue, stop: threading.Event,
                 thread: threading.Thread):
        self._q = q
        self._stop = stop
        self._thread = thread

    def close(self, timeout: float = 1.0):
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)


def device_prefetch(it: Iterator[MiniBatch], *, size: int = 2,
                    device="cuda") -> Iterator[MiniBatch]:
    """Wrap a MiniBatch iterator so its batches are staged to ``device``
    ``size`` steps ahead, by a thread (module docstring). With a CPU
    ``device`` nothing is staged: the batches pass through as they
    are. ``"cuda"`` without a card raises.

    An error of the upstream iterator or of a copy is raised in the
    consumer, never taken for the end of the data. Abandoning the
    generator (``close()``, an end trigger firing mid-epoch) stops the
    stager: each of its queue operations is bounded and checks a stop
    event, and the consumer's ``finally`` drains and joins it. Each
    staging goes through the ``prefetch/stage`` fault point."""
    device = torch.device(device)
    stager = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_prefetch to a CUDA device needs a card; pass "
                "device='cpu' to stage nothing")
        stager = _CudaStager(device, size + 2)
    return _staged(iter(it), size, device, stager)


def _staged(it, size: int, device, stager) -> Iterator[MiniBatch]:
    """The consumer side of :func:`device_prefetch` and its stager."""
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()
    error: list = []

    def put_bounded(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage():
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                batch = next(it, _END)
                if batch is _END:
                    break
                # an injected failure rides the error channel to the
                # consumer, never a silent end of the data
                faults.point("prefetch/stage")
                staged = (batch, None) if stager is None \
                    else stager.stage(batch)
                _STAGE_S.observe(time.perf_counter() - t0)
                _STAGED.inc()
                if not put_bounded(staged):
                    return
                _QUEUE_DEPTH.set(q.qsize())
        except BaseException as e:  # raised again in the consumer
            error.append(e)
        finally:
            put_bounded(_END)

    t = threading.Thread(target=stage, daemon=True,
                         name="device_prefetch")
    t.start()
    handle = _PrefetchHandle(q, stop, t)
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if item is not _END:
                # waiting for the end sentinel is not feed latency
                _FETCH_WAIT_S.observe(time.perf_counter() - t0)
            _QUEUE_DEPTH.set(q.qsize())
            if item is _END:
                if error:
                    raise error[0]
                return
            batch, event = item
            if event is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(event)
                for x in _tensors([batch.input, batch.target]):
                    x.record_stream(cur)
            yield batch
    finally:
        handle.close()

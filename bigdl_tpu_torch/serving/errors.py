"""The serving stack's typed errors (counterpart of the three in
``bigdl_tpu.serving.batcher``)."""
from __future__ import annotations

__all__ = ["DeadlineExceeded", "QueueFull", "WorkerDied"]


class QueueFull(RuntimeError):
    """Admission control: the request queue is at max_queue depth."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it could be served."""


class WorkerDied(RuntimeError):
    """The serving worker thread died outside the per-request error
    handling. Every pending request fails with this — typed, promptly —
    instead of hanging, and the supervisor restarts the worker."""

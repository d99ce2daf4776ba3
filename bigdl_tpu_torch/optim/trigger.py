"""Trigger algebra (counterpart of ``bigdl_tpu.optim.trigger``): a
trigger is a predicate over the driver state dict (``epoch``,
``neval``, ``Loss``, ...).

Not ported yet: the window-planning ``depends_on`` / ``peek`` surface
(the port has no fused multi-step windows), ``max_score`` and
``min_loss``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

__all__ = ["Trigger", "every_epoch", "max_epoch", "max_iteration",
           "several_iteration"]


class Trigger:
    """Composable predicate over driver state; ``and_`` / ``or_`` build
    the reference's trigger algebra."""

    def __init__(self, fn: Callable[[Dict[str, Any]], bool]):
        self._fn = fn

    def __call__(self, state: Dict[str, Any]) -> bool:
        return self._fn(state)

    def and_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) and other(s))

    def or_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) or other(s))


def every_epoch() -> Trigger:
    """Fires once each time the epoch counter advances (the first call
    only latches the baseline)."""
    holder = {"last": None}

    def fn(state):
        cur = state.get("epoch", 1)
        if holder["last"] is None:
            holder["last"] = cur
            return False
        if cur > holder["last"]:
            holder["last"] = cur
            return True
        return False

    return Trigger(fn)


def several_iteration(interval: int) -> Trigger:
    """Fires every ``interval`` iterations."""
    return Trigger(lambda s: s.get("neval", 1) % interval == 0)


def max_epoch(m: int) -> Trigger:
    """End condition: epoch > m."""
    return Trigger(lambda s: s.get("epoch", 1) > m)


def max_iteration(m: int) -> Trigger:
    """End condition: neval > m."""
    return Trigger(lambda s: s.get("neval", 1) > m)

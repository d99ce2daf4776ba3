"""Trigger algebra (counterpart of ``bigdl_tpu.optim.trigger``): a
trigger is a predicate over the driver state dict (``epoch``,
``neval``, ``Loss``, ...).

Triggers also declare which state keys they read (``depends_on``) and
offer a side-effect-free ``peek``: the windowed driver
(``Optimizer.set_steps_per_sync``) simulates the counters across a
window and must know, before it runs the window, whether a trigger
would fire inside it — without advancing a stateful trigger such as
``every_epoch``. A trigger whose dependencies are unknown
(``depends_on is None``) or that reads values only the device produces
(``Loss``, ``score``) cannot be planned, and the driver falls back to
per-step windows.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, FrozenSet, Optional

__all__ = ["PLANNABLE_KEYS", "Trigger", "every_epoch", "max_epoch",
           "max_iteration", "max_score", "min_loss", "several_iteration"]

#: driver-state keys whose future values the windowed planner can
#: simulate exactly on the host (counter arithmetic)
PLANNABLE_KEYS = frozenset({"epoch", "neval", "recordsProcessedThisEpoch"})


def _union(a: Optional[FrozenSet[str]], b: Optional[FrozenSet[str]]):
    return None if a is None or b is None else a | b


class Trigger:
    """Composable predicate over driver state; ``and_`` / ``or_`` build
    the reference's trigger algebra.

    ``depends_on`` is the set of state keys the predicate reads (None:
    unknown, the default for a hand-written trigger); ``peek`` evaluates
    without changing any trigger state and defaults to the predicate
    itself (right for every stateless trigger)."""

    def __init__(self, fn: Callable[[Dict[str, Any]], bool],
                 depends_on: Optional[FrozenSet[str]] = None,
                 peek: Optional[Callable[[Dict[str, Any]], bool]] = None):
        self._fn = fn
        self.depends_on = frozenset(depends_on) \
            if depends_on is not None else None
        self._peek = peek

    def __call__(self, state: Dict[str, Any]) -> bool:
        return self._fn(state)

    def peek(self, state: Dict[str, Any]) -> bool:
        """Evaluate against ``state`` without advancing any internal
        state: what the windowed driver calls on simulated states."""
        return (self._peek or self._fn)(state)

    def plannable(self) -> bool:
        """True when the windowed driver can predict this trigger's
        firings from simulated counters alone."""
        return self.depends_on is not None \
            and self.depends_on <= PLANNABLE_KEYS

    def and_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) and other(s),
                       depends_on=_union(self.depends_on, other.depends_on),
                       peek=lambda s: self.peek(s) and other.peek(s))

    def or_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) or other(s),
                       depends_on=_union(self.depends_on, other.depends_on),
                       peek=lambda s: self.peek(s) or other.peek(s))


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

    def peek(state):
        # before the first real call nothing is latched: no fire
        if holder["last"] is None:
            return False
        return state.get("epoch", 1) > holder["last"]

    return Trigger(fn, depends_on=frozenset({"epoch"}), peek=peek)


def several_iteration(interval: int) -> Trigger:
    """Fires every ``interval`` iterations."""
    return Trigger(lambda s: s.get("neval", 1) % interval == 0,
                   depends_on=frozenset({"neval"}))


def max_epoch(m: int) -> Trigger:
    """End condition: epoch > m."""
    return Trigger(lambda s: s.get("epoch", 1) > m,
                   depends_on=frozenset({"epoch"}))


def max_iteration(m: int) -> Trigger:
    """End condition: neval > m."""
    return Trigger(lambda s: s.get("neval", 1) > m,
                   depends_on=frozenset({"neval"}))


def max_score(m: float) -> Trigger:
    """End condition: the last validation score (``score``) exceeds
    ``m``."""
    return Trigger(lambda s: s.get("score", float("-inf")) > m,
                   depends_on=frozenset({"score"}))


def min_loss(m: float) -> Trigger:
    """End condition: the last training loss (``Loss``) is below ``m``."""
    return Trigger(lambda s: s.get("Loss", float("inf")) < m,
                   depends_on=frozenset({"Loss"}))

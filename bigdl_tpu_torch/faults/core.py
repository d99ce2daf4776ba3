"""Deterministic fault injection: named fault points and scripted
schedules (counterpart of ``bigdl_tpu.faults.core``).

Code declares **fault points**, named host-side call sites
(``faults.point("ckpt/write_manifest", neval=4)``) at the spots where
real systems die: mid-checkpoint-write, on the serving dispatch thread,
inside a decode step. A test **arms** a :class:`FaultSchedule` scripting
what each point does: fail on the Nth matching call, fail with a seeded
probability, inject latency, raise a chosen exception type, or SIGKILL
the process.

Disarmed is the default and costs one module-flag check per call, so
points stay in hot loops. Armed, every fired fault lands in the
``faults/point/injected`` counter (labelled ``point=<name>``), so
injected faults can be reconciled against recovery counters.

Schedules are deterministic: per-rule call counters and per-rule seeded
``random.Random`` streams, and every rule of a point observes every call
(sibling-rule order never changes an ``nth`` count), so a seeded
schedule fires on the same calls here as in the JAX package.

String syntax (``parse_schedule``)::

    point=opt,opt,...;point=opt,...

    train/step=nth:3,raise:RuntimeError        # 3rd call raises
    fetch/download=nth:1-2,raise:OSError       # calls 1 and 2 raise
    serving/dispatch=prob:0.5,seed:7,times:2   # seeded coin, max twice
    prefetch/stage=delay:20                    # inject 20ms latency
    ckpt/write_manifest=match:neval=4,sigkill  # SIGKILL at neval 4

Not ported yet: the flight recorder's note of each fire and its dump
before a SIGKILL (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from bigdl_tpu_torch import telemetry

__all__ = ["FaultRule", "FaultSchedule", "InjectedFault", "KNOWN_POINTS",
           "NAMED_EXCEPTIONS", "active_schedule", "arm", "armed", "disarm",
           "injected_total", "is_armed", "parse_schedule", "point"]

_INJECTED = telemetry.counter(
    "faults/point/injected",
    "faults fired by the armed schedule (labelled point=<name>)")


class InjectedFault(RuntimeError):
    """The default exception an armed fault point raises (transient to
    :func:`bigdl_tpu_torch.faults.retry.classify`, so recovery paths run
    their real retry logic)."""


#: exception types a schedule string may name (``raise:OSError``);
#: programmatic rules accept any exception class
NAMED_EXCEPTIONS: Dict[str, type] = {
    "InjectedFault": InjectedFault,
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
    "TypeError": TypeError,
}

_ACTIONS = ("raise", "sigkill", "delay")

#: every fault point name of the library, with the failure it models —
#: the JAX package's table whole. A schedule may script only these (a
#: typo'd schedule would silently never fire); the port places the
#: serving, training and checkpoint points and the fleet's.
KNOWN_POINTS: Dict[str, str] = {
    "ckpt/write_manifest": "between checkpoint payload and manifest "
                           "commit (torn-write window)",
    "train/step": "inside one optimizer step (mid-training death)",
    "fetch/download": "inside one dataset download attempt",
    "prefetch/stage": "inside one prefetch staging copy",
    "datapipe/read": "inside one datapipe shard read",
    "serving/dispatch": "on the serving dispatch thread",
    "serving/take_batch": "taking a batch off the admission queue",
    "serving/swap": "inside a model-version hot-swap",
    "serving/decode": "inside one continuous-batching decode step",
    "file_io/remote_write": "inside one remote (non-local) write",
    "fleet/route": "at the router's placement edge",
    "fleet/replica": "at a replica's submit path (injection here IS "
                     "that replica's death)",
    "fleet/verify": "inside speculative-decode verification",
    "fleet/spawn": "at the autoscaler's spawn actuation, before the "
                   "replica is built (aborted scale-up)",
    "fleet/drain": "at the autoscaler's drain actuation, before the "
                   "drain starts (aborted scale-down)",
    "fleet/deploy": "at every deploy state-machine transition, "
                    "before it commits",
    "fleet/canary_swap": "at each incumbent's hot-swap during a "
                         "fleet-wide deploy (aborted swap reverts "
                         "the already-swapped)",
}


class FaultRule:
    """One scripted behaviour for one fault point.

    ``when`` is the conjunction of every given matcher: call number
    (``nth``, a (first, last) inclusive range over MATCHING calls),
    seeded probability (``prob``/``seed``) and context equality
    (``match``, against the keywords the call site passes). ``times``
    bounds total fires. ``action`` is ``"raise"`` (with ``exc``),
    ``"sigkill"`` or ``"delay"``; ``delay_ms`` of latency comes before
    any action (so a rule can be pure latency)."""

    def __init__(self, point: str, *, action: str = "raise",
                 exc: type = InjectedFault, nth=None,
                 prob: Optional[float] = None, seed: int = 0,
                 times: Optional[int] = None,
                 match: Optional[Dict[str, Any]] = None,
                 predicate: Optional[Callable[[Dict[str, Any]], bool]]
                 = None,
                 delay_ms: float = 0.0):
        if action not in _ACTIONS:
            raise ValueError(
                f"action must be one of {_ACTIONS}, got {action!r}")
        if isinstance(nth, int):
            nth = (nth, nth)
        self.point = point
        self.action = action
        self.exc = exc
        self.nth = nth
        self.prob = prob
        self.times = times
        self.match = dict(match) if match else None
        self.predicate = predicate
        self.delay_ms = float(delay_ms)
        self._rng = random.Random(seed)
        self.calls = 0   # matching-context calls seen
        self.fired = 0   # faults actually injected

    def consider(self, ctx: Dict[str, Any]) -> bool:
        """Whether this rule would fire for one call. Advances the
        rule's deterministic state (matching-call counter, seeded
        stream) but not ``fired``: the caller records the one winning
        fire. Caller holds the schedule lock."""
        if self.match is not None and any(
                ctx.get(k) != v for k, v in self.match.items()):
            return False
        if self.predicate is not None and not self.predicate(ctx):
            return False
        self.calls += 1
        ok = True
        if self.times is not None and self.fired >= self.times:
            ok = False
        if self.nth is not None and not (
                self.nth[0] <= self.calls <= self.nth[1]):
            ok = False
        if self.prob is not None and self._rng.random() >= self.prob:
            ok = False
        return ok

    def __repr__(self) -> str:
        return (f"FaultRule({self.point!r}, action={self.action!r}, "
                f"nth={self.nth}, prob={self.prob}, times={self.times}, "
                f"match={self.match}, fired={self.fired})")


class FaultSchedule:
    """An ordered set of :class:`FaultRule`; the first rule that fires
    for a call wins. ``fired()`` reports per-point injection counts."""

    def __init__(self, rules: Optional[List[FaultRule]] = None):
        self.rules: List[FaultRule] = list(rules or [])

    def add(self, rule: FaultRule) -> "FaultSchedule":
        """Append one rule; returns self for chaining."""
        self.rules.append(rule)
        return self

    def fired(self) -> Dict[str, int]:
        """Per-point counts of faults this schedule injected."""
        out: Dict[str, int] = {}
        for r in self.rules:
            out[r.point] = out.get(r.point, 0) + r.fired
        return out

    def total_fired(self) -> int:
        """Total faults injected across every rule."""
        return sum(r.fired for r in self.rules)


def _parse_rule(spec: str) -> FaultRule:
    point, _, opts = spec.partition("=")
    point = point.strip()
    if not point or not opts:
        raise ValueError(
            f"bad fault spec {spec!r}: want point=opt,opt,...")
    kw: Dict[str, Any] = {}
    for opt in opts.split(","):
        opt = opt.strip()
        key, _, val = opt.partition(":")
        if key == "raise":
            kw["action"] = "raise"
            if val:
                if val not in NAMED_EXCEPTIONS:
                    raise ValueError(
                        f"unknown exception {val!r} (one of "
                        f"{sorted(NAMED_EXCEPTIONS)})")
                kw["exc"] = NAMED_EXCEPTIONS[val]
        elif key == "sigkill":
            kw["action"] = "sigkill"
        elif key == "delay":
            kw.setdefault("action", "delay")
            kw["delay_ms"] = float(val)
        elif key == "nth":
            lo, _, hi = val.partition("-")
            kw["nth"] = (int(lo), int(hi) if hi else int(lo))
        elif key == "prob":
            kw["prob"] = float(val)
        elif key == "seed":
            kw["seed"] = int(val)
        elif key == "times":
            kw["times"] = int(val)
        elif key == "match":
            mk, _, mv = val.partition("=")
            m = kw.setdefault("match", {})
            try:
                m[mk] = int(mv)
            except ValueError:
                m[mk] = mv
        else:
            raise ValueError(f"unknown fault option {opt!r} in {spec!r}")
    return FaultRule(point, **kw)


def parse_schedule(text: str) -> FaultSchedule:
    """Parse the compact ``point=opt,...;point=opt,...`` schedule string
    (module docstring has the grammar) into a :class:`FaultSchedule`."""
    rules = [_parse_rule(s) for s in text.split(";") if s.strip()]
    if not rules:
        raise ValueError(f"empty fault schedule {text!r}")
    return FaultSchedule(rules)


# -- the armed-schedule singleton ----------------------------------------
# _ARMED is the ONE flag the disarmed point() fast path reads; everything
# else sits behind it
_ARMED = False
_SCHEDULE: Optional[FaultSchedule] = None
_LOCK = threading.Lock()


def is_armed() -> bool:
    """Whether a fault schedule is currently armed."""
    return _ARMED


def active_schedule() -> Optional[FaultSchedule]:
    """The armed (or last-armed) schedule, None before the first arm —
    read its ``fired()`` to reconcile injections."""
    return _SCHEDULE


def arm(schedule) -> FaultSchedule:
    """Arm a :class:`FaultSchedule` (or a schedule string, parsed by
    :func:`parse_schedule`). Replaces any armed schedule; returns it.
    Arming is always an explicit call: no environment variable arms a
    schedule."""
    global _ARMED, _SCHEDULE
    if isinstance(schedule, str):
        schedule = parse_schedule(schedule)
    with _LOCK:
        _SCHEDULE = schedule
        _ARMED = True
    return schedule


def disarm() -> None:
    """Disarm fault injection; the schedule stays readable through
    :func:`active_schedule` for reconciliation."""
    global _ARMED
    with _LOCK:
        _ARMED = False


class _Armed:
    """Context-manager form of arm()/disarm()."""

    def __init__(self, schedule):
        self.schedule = arm(schedule)

    def __enter__(self) -> FaultSchedule:
        return self.schedule

    def __exit__(self, *exc) -> None:
        disarm()


def armed(schedule) -> _Armed:
    """``with faults.armed("train/step=nth:2,raise"):`` — arm for the
    block, disarm on exit; yields the parsed :class:`FaultSchedule`."""
    return _Armed(schedule)


def injected_total() -> int:
    """Total faults the armed (or last-armed) schedule injected."""
    s = _SCHEDULE
    return s.total_fired() if s is not None else 0


def point(name: str, /, **ctx) -> None:
    """Declare a fault point: a no-op unless a schedule is armed AND has
    a rule for ``name`` whose matchers accept this call (the disarmed
    path is one flag check).

    Armed, the winning rule injects its latency (``delay_ms``), then
    raises its exception, SIGKILLs this process, or returns (pure
    latency). Every fire counts into ``faults/point/injected`` (label
    ``point=<name>``) before it acts."""
    if not _ARMED:
        return
    with _LOCK:
        sched = _SCHEDULE
        if sched is None:
            return
        hit = None
        for r in sched.rules:
            # every rule for the point observes the call (counters and
            # seeded streams advance deterministically); the FIRST rule
            # that fires wins and records it
            if r.point == name and r.consider(ctx) and hit is None:
                hit = r
        if hit is not None:
            hit.fired += 1
    if hit is None:
        return
    _INJECTED.inc(point=name)
    if hit.delay_ms:
        time.sleep(hit.delay_ms / 1000.0)
    if hit.action == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    if hit.action == "raise":
        raise hit.exc(
            f"injected fault at {name!r} (call {hit.calls}, ctx {ctx})")

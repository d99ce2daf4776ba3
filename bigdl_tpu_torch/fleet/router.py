"""The replica fleet router: least-loaded sticky placement, breaker
health, draining rebalance, typed shed (counterpart of
``bigdl_tpu.fleet.router``).

The router holds N replicas (:class:`~bigdl_tpu_torch.fleet.replica.
Replica` or :class:`~bigdl_tpu_torch.fleet.replica.ProcessReplica`,
duck-typed) and places each request:

1. **session stickiness** — a ``session=`` id pins to the replica that
   served it last (its prefix cache and slots are warm), for as long as
   that replica is serving and its breaker admits;
2. **least-loaded** otherwise — fewest live slots + queued requests
   among replicas whose ``accepting()`` gate passes (serving state AND
   the replica's :class:`~bigdl_tpu_torch.serving.breaker.
   CircuitBreaker`, fed by stream outcomes);
3. **typed fast-reject** when nothing accepts: every replica
   breaker-open, draining or dead ⇒ :class:`~bigdl_tpu_torch.serving.
   breaker.Degraded`; every accepting replica queue-full ⇒
   :class:`~bigdl_tpu_torch.serving.errors.QueueFull`.

A request's handle is a :class:`FleetStream`, a
:class:`~bigdl_tpu_torch.generation.stream.TokenStream` that mirrors the
placed replica's stream and, when that replica **dies** mid-flight,
re-routes: the prompt is resubmitted (same seed) to a healthy replica
and the deterministic replay is deduplicated token by token, so the
caller's iterator sees no seam. A death with no healthy peer left fails
typed (``WorkerDied``). Replica deaths count into
``fleet/replica/evictions``; the ``fleet/route`` fault point sits at the
submit edge.

Draining rebalance (hot-swap): ``drain(name)`` keeps a replica's held
streams running while new sessions route elsewhere; ``resume`` or
:meth:`FleetRouter.remove` ends it. ``set_split`` routes a seeded share
of placements to a canary.

Not ported yet: ``fleet_snapshot`` over a telemetry directory (ROADMAP
queue 1, item 12).
"""
from __future__ import annotations

import random
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from bigdl_tpu_torch import faults, telemetry
from bigdl_tpu_torch.generation.stream import TokenStream
from bigdl_tpu_torch.serving.breaker import Degraded
from bigdl_tpu_torch.serving.errors import QueueFull, WorkerDied

__all__ = ["MAX_SESSIONS", "FleetRouter", "FleetStream",
           "register_router_instruments"]

#: session-pin table bound: the oldest pin is dropped past this many
#: live sessions (a dropped pin just re-places the session's next
#: request — stickiness is an optimization, not a correctness rule)
MAX_SESSIONS = 4096


def register_router_instruments(r) -> Dict[str, object]:
    """Get-or-create the ``fleet/router/*`` + ``fleet/replica/*``
    instruments in registry ``r``."""
    return {
        "requests": r.counter(
            "fleet/router/requests", "requests placed by the router"),
        "shed": r.counter(
            "fleet/router/shed",
            "requests fast-rejected typed (every replica shedding)"),
        "reroutes": r.counter(
            "fleet/router/reroutes",
            "streams re-placed onto another replica after a death"),
        "evictions": r.counter(
            "fleet/replica/evictions",
            "replica deaths observed and evicted by the router"),
        "replicas": r.gauge(
            "fleet/router/replicas", "replicas currently registered"),
        "load": r.gauge(
            "fleet/replica/load",
            "live slots + queued requests (labelled replica=<name>)"),
        "canary_routes": r.counter(
            "fleet/router/canary_routes",
            "requests the traffic split placed on the canary replica"),
    }


class FleetStream(TokenStream):
    """The router-level handle on one generation (class docstring of
    the module has the re-route contract). Mirrors the placed
    replica's stream; deterministic replay after a re-route is
    deduplicated by token index, so consumers see one seamless
    stream."""

    def __init__(self, router: "FleetRouter", prompt: np.ndarray,
                 kwargs: Dict, retries: int, trace_id: str):
        super().__init__(int(prompt.shape[0]),
                         kwargs.get("max_new_tokens") or 0,
                         trace_id=trace_id)
        self._router = router
        self._req_prompt = prompt
        self._req_kwargs = kwargs
        self._retries_left = retries
        self._session: Optional[str] = None
        self._replica = None
        self._inner: Optional[TokenStream] = None
        self._pending: Dict[int, int] = {}
        # serializes the dedup window below: during a re-route the NEW
        # replica's decode thread delivers tokens concurrently with the
        # death-callback thread's attach-replay of the OLD stream's
        # tokens; the check-then-push must be atomic or a replayed
        # token can slip in twice (lock order: _route_lock -> _cond,
        # nothing under _cond calls back into the router layer)
        self._route_lock = threading.Lock()

    # --------------------------------------------------- observer side
    def _bind(self, replica, inner: TokenStream) -> None:
        with self._route_lock:
            self._replica = replica
            self._inner = inner
        # attach OUTSIDE the lock: the replay it triggers re-enters
        # on_token, which takes _route_lock itself
        inner._attach(self)

    def on_token(self, i: int, token: int) -> None:
        """Inner-stream token (replayed tokens after a re-route arrive
        again with their original indices and are dropped here)."""
        with self._route_lock:
            have = len(self.tokens())
            if i < have:
                return  # deterministic replay of a token we already hold
            if i > have:
                self._pending[i] = token  # attach-replay racing a push
                return
            self._push(token)
            nxt = len(self.tokens())
            while nxt in self._pending:
                self._push(self._pending.pop(nxt))
                nxt += 1

    def on_finish(self, reason: str) -> None:
        with self._route_lock:
            inner = self._inner
        if inner is not None:
            # flush any tokens the observer hasn't seen yet (attach
            # raced the final pushes)
            for i, tok in enumerate(inner.tokens()):
                self.on_token(i, tok)
        self._router._stream_ok(self._replica)
        self._finish(reason)

    def on_fail(self, err: BaseException) -> None:
        self._router._stream_failed(self, err)


class FleetRouter:
    """Health-aware session router over N generation replicas (module
    docstring has the placement and failure contracts)."""

    def __init__(self, replicas=(), *, metrics=None,
                 reroute_retries: int = 1,
                 telemetry_dir: Optional[str] = None):
        self._lock = threading.Lock()
        self._replicas: "OrderedDict[str, object]" = OrderedDict()
        self._sessions: "OrderedDict[str, str]" = OrderedDict()
        self._evicted: set = set()
        self._seq = 0
        self.reroute_retries = int(reroute_retries)
        # the router's fleet snapshot directory (fleet_snapshot)
        self.telemetry_dir = telemetry_dir
        r = metrics if metrics is not None else telemetry.REGISTRY
        self.metrics_registry = r
        inst = register_router_instruments(r)
        self._c_requests = inst["requests"]
        self._c_shed = inst["shed"]
        self._c_reroutes = inst["reroutes"]
        self._c_evictions = inst["evictions"]
        self._g_replicas = inst["replicas"]
        self._g_load = inst["load"]
        self._c_canary = inst["canary_routes"]
        #: (name, fraction, seeded rng) while a canary split is active
        self._split = None
        for rep in replicas:
            self.add(rep)

    # ------------------------------------------------------- replicas
    def add(self, replica) -> None:
        """Register one replica (serving immediately)."""
        with self._lock:
            if replica.name in self._replicas:
                raise ValueError(
                    f"replica {replica.name!r} already registered")
            self._replicas[replica.name] = replica
            # a replacement replica under a dead one's name starts
            # with a clean eviction state (and bounds _evicted by the
            # live name set)
            self._evicted.discard(replica.name)
            self._g_replicas.set(len(self._replicas))

    def remove(self, name: str, drain: bool = True):
        """Deregister (and shut down) one replica; with ``drain`` its
        held streams finish first. Returns the replica."""
        with self._lock:
            replica = self._replicas.pop(name, None)
            self._g_replicas.set(len(self._replicas))
            for sess in [s for s, rn in self._sessions.items()
                         if rn == name]:
                del self._sessions[sess]
        if replica is not None:
            replica.shutdown(drain=drain)
        return replica

    def drain(self, name: str) -> None:
        """Hot-swap rebalance: the named replica finishes its streams,
        new sessions route elsewhere (``replica.resume()`` or
        :meth:`remove` ends the drain)."""
        with self._lock:
            replica = self._replicas.get(name)
        if replica is None:
            raise KeyError(f"no replica {name!r}")
        replica.drain()

    def replicas(self) -> List:
        """Registered replicas (snapshot)."""
        with self._lock:
            return list(self._replicas.values())

    # --------------------------------------------------- canary split
    def set_split(self, name: str, fraction: float,
                  seed: int = 0) -> None:
        """Route a seeded ``fraction`` of placements to replica
        ``name`` (the canary) and keep it OUT of everyone else's
        candidate order — the deploy pipeline's traffic split: the
        canary sees exactly its share, the incumbent fleet's window
        stays unpolluted. A draw that picks a canary which cannot take
        the request (full/shedding) falls through to the incumbents —
        a split can narrow placement, never hang it."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], "
                             f"got {fraction}")
        with self._lock:
            self._split = (name, float(fraction), random.Random(seed))

    def clear_split(self) -> None:
        """End the canary traffic split (canary rejoins the normal
        least-loaded order if still registered)."""
        with self._lock:
            self._split = None

    def _evict(self, replica) -> None:
        """Observe one replica death exactly once: count it, drop its
        session pins (their next requests re-place)."""
        with self._lock:
            if replica.name in self._evicted:
                return
            self._evicted.add(replica.name)
            for sess in [s for s, rn in self._sessions.items()
                         if rn == replica.name]:
                del self._sessions[sess]
        self._c_evictions.inc(replica=replica.name)

    # ------------------------------------------------------ placement
    def _candidates(self, session: Optional[str]):
        """Accepting replicas, least-loaded first — the sticky
        replica (if still accepting) leads. Also reports whether ANY
        replica exists at all (for the typed-shed distinction)."""
        with self._lock:
            reps = list(self._replicas.values())
            pinned = self._sessions.get(session) if session else None
        loads = []
        for rep in reps:
            if rep.state == "dead":
                self._evict(rep)
                continue
            if not rep.accepting():
                continue
            load = rep.load()
            self._g_load.set(load, replica=rep.name)
            loads.append((load, rep))
        loads.sort(key=lambda t: t[0])
        ordered = [rep for _, rep in loads]
        if pinned is not None:
            for rep in ordered:
                if rep.name == pinned:
                    ordered.remove(rep)
                    ordered.insert(0, rep)
                    break
        with self._lock:
            split = self._split
        if split is not None:
            cname, fraction, rng = split
            canary = next((r for r in ordered if r.name == cname),
                          None)
            if canary is not None:
                with self._lock:  # Random isn't thread-safe
                    take = rng.random() < fraction
                ordered.remove(canary)
                if take:
                    # canary draw leads; incumbents still back it up
                    ordered.insert(0, canary)
        return ordered, bool(reps)

    def _pin(self, session: Optional[str], replica) -> None:
        if session is None:
            return
        with self._lock:
            self._sessions[session] = replica.name
            self._sessions.move_to_end(session)
            while len(self._sessions) > MAX_SESSIONS:
                self._sessions.popitem(last=False)

    def _place(self, stream: FleetStream, session: Optional[str],
               first: bool) -> None:
        """Try candidates in order; raises typed when none take it."""
        ordered, any_replica = self._candidates(session)
        last_qfull = None
        for rep in ordered:
            try:
                inner = rep.submit(stream._req_prompt,
                                   **stream._req_kwargs)
            except QueueFull as e:
                last_qfull = e
                continue
            except WorkerDied:
                # the fleet/replica faultpoint killed it at submit
                self._evict(rep)
                continue
            self._pin(session, rep)
            if not first:
                self._c_reroutes.inc(replica=rep.name)
            with self._lock:
                split = self._split
            if split is not None and rep.name == split[0]:
                self._c_canary.inc(replica=rep.name)
            stream._bind(rep, inner)
            return
        if last_qfull is not None:
            raise QueueFull(
                f"every accepting replica is at queue depth "
                f"({len(ordered)} tried)") from last_qfull
        self._c_shed.inc()
        if any_replica:
            raise Degraded(
                "every replica is shedding (breaker open, draining or "
                "dead); retry after a cooldown")
        raise Degraded("no replicas registered")

    # --------------------------------------------------------- submit
    def submit(self, prompt, *, session: Optional[str] = None,
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               seed: int = 0,
               timeout_ms: Optional[float] = None) -> FleetStream:
        """Place one generation on the fleet; returns a
        :class:`FleetStream`. Raises typed at the submit edge:
        :class:`Degraded` when every replica sheds, :class:`QueueFull`
        when every accepting replica is at depth."""
        faults.point("fleet/route", session=session or "")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            self._seq += 1
            seq = self._seq
        kwargs = dict(max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, seed=seed,
                      timeout_ms=timeout_ms)
        stream = FleetStream(self, prompt, kwargs, self.reroute_retries,
                             trace_id=f"fleet/req-{seq}")
        stream._session = session
        self._place(stream, session, first=True)
        self._c_requests.inc()
        return stream

    # ------------------------------------------------------- outcomes
    def _stream_failed(self, stream: FleetStream,
                       err: BaseException) -> None:
        """A placed stream failed: feed the breaker, and re-route when
        the replica died and retries remain — otherwise fail the
        fleet stream with the same typed error."""
        replica = stream._replica
        died = isinstance(err, WorkerDied) or (
            replica is not None and replica.state == "dead")
        if replica is not None:
            if died:
                replica.breaker.on_failure()
                if replica.state == "dead":
                    self._evict(replica)
        if died and stream._retries_left > 0:
            stream._retries_left -= 1
            try:
                self._place(stream, getattr(stream, "_session", None),
                            first=False)
                return
            except Exception as e:  # no healthy peer took it: typed
                err = WorkerDied(
                    f"replica died and re-route failed "
                    f"({type(e).__name__}: {e})")
        stream._fail(err)

    def _stream_ok(self, replica) -> None:
        if replica is not None:
            replica.breaker.on_success()

    # -------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, float]:
        """Router-level snapshot: placement counters + per-replica
        states."""
        r = self.metrics_registry
        with self._lock:
            reps = list(self._replicas.values())
            sessions = len(self._sessions)
        return {
            "requests": int(r.counter("fleet/router/requests").value()),
            "shed": int(r.counter("fleet/router/shed").value()),
            "reroutes": int(r.counter("fleet/router/reroutes").total()),
            "evictions": int(r.counter(
                "fleet/replica/evictions").total()),
            "replicas": len(reps),
            "sessions": sessions,
            "states": {rep.name: rep.state for rep in reps},
        }

    def fleet_snapshot(self):
        """The merged fleet snapshot: ``[]`` when the router owns no
        telemetry directory. Merging the replicas' shipped snapshots
        waits for the port's telemetry slice (``telemetry.agg``, ROADMAP
        queue 1, item 12) and raises NotImplementedError."""
        if not self.telemetry_dir:
            return []
        raise NotImplementedError(
            "FleetRouter.fleet_snapshot with a telemetry directory: "
            "snapshot aggregation waits for the port's telemetry slice "
            "(ROADMAP queue 1, item 12)")

    def shutdown(self, drain: bool = True) -> None:
        """Stop every replica (``drain`` finishes held streams)."""
        for rep in self.replicas():
            rep.shutdown(drain=drain)

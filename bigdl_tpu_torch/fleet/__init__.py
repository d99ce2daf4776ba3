"""Generation serving beyond one loop (counterpart of ``bigdl_tpu.fleet``):

- :mod:`~bigdl_tpu_torch.fleet.prefix` — repeated prompts skip
  prefill: a reference-counted, capacity-bounded cache of committed KV
  blocks seeds the slot by device copy (full-prompt hits), and under
  chunked prefill a shared chunk-boundary prefix seeds the covered
  chunks (partial hits);
- :mod:`~bigdl_tpu_torch.fleet.speculative` — a small draft model
  proposes ``k`` tokens, the target adjudicates them in one batched
  forward (one extra program a rung: the per-(version, bucket) bound
  grows from 2 to 3); greedy acceptance equals target-only decode,
  seeded sampling uses rejection sampling;
- :mod:`~bigdl_tpu_torch.fleet.router` / :mod:`~bigdl_tpu_torch.fleet.
  replica` — replicas (thread- or process-hosted) behind least-loaded
  sticky placement with per-replica breakers, draining rebalance, typed
  sheds, and re-routing of streams off a dead replica;
- :func:`~bigdl_tpu_torch.fleet.soak.build_replicas` — a fleet of
  identical seeded replicas.

Not ported yet: ``run_fleet_soak``, the autoscaler (``control``),
multi-tenant admission and the deploy state machine; they need the
port's telemetry slice (``slo``, ``flight``, ``agg``: ROADMAP queue 1,
item 12).
"""
from bigdl_tpu_torch.fleet.prefix import (PrefixCache, PrefixEntry,
                                          register_prefix_instruments)
from bigdl_tpu_torch.fleet.replica import ProcessReplica, Replica
from bigdl_tpu_torch.fleet.router import (MAX_SESSIONS, FleetRouter,
                                          FleetStream,
                                          register_router_instruments)
from bigdl_tpu_torch.fleet.soak import build_replicas
from bigdl_tpu_torch.fleet.speculative import (
    SpeculativeConfig, SpeculativeDecoder, register_speculative_instruments)

__all__ = [
    "FleetRouter", "FleetStream", "MAX_SESSIONS", "PrefixCache",
    "PrefixEntry", "ProcessReplica", "Replica", "SpeculativeConfig",
    "SpeculativeDecoder", "build_replicas", "register_fleet_instruments",
    "register_prefix_instruments", "register_router_instruments",
    "register_speculative_instruments",
]


def register_fleet_instruments(r):
    """Get-or-create the ported ``fleet/*`` instruments (prefix, router,
    speculative) in registry ``r``."""
    out = dict(register_prefix_instruments(r))
    out.update(register_router_instruments(r))
    out.update(register_speculative_instruments(r))
    return out

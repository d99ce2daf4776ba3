"""Building a fleet of identical replicas (counterpart of the
``build_replicas`` half of ``bigdl_tpu.fleet.soak``).

Not ported yet: ``run_fleet_soak``, the sustained heavy-traffic soak
that asserts p99 budgets under QueueFull pressure; it needs the port's
``telemetry.slo`` (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch

__all__ = ["build_replicas"]


def build_replicas(n: int, *, seed: int = 42, vocab: int = 32,
                   hidden: int = 16, layers: int = 1, heads: int = 2,
                   slots: int = 2, max_len: int = 16,
                   max_queue: int = 4, metrics=None,
                   prefix_cache_bytes: int = 0,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> List:
    """N thread-hosted replicas of ONE seeded TransformerLM on
    ``device`` (the card by default): identical weights, so greedy
    outputs are comparable across replicas, which is what lets a
    re-routed stream equal an undisturbed one. Each serves one rung
    (``max_len``) with prefill batches of ``min(2, slots)``, as the JAX
    package's do."""
    from bigdl_tpu_torch.fleet.replica import Replica, model_from_spec
    from bigdl_tpu_torch.generation.service import GenerationConfig

    spec = dict(seed=seed, vocab_size=vocab, hidden_size=hidden,
                num_layers=layers, num_heads=heads, max_len=max_len)
    return [Replica(
        f"r{i}", model_from_spec(spec, max_len, device),
        config=GenerationConfig(
            slots=slots, max_len=max_len, length_buckets=(max_len,),
            prefill_rows=min(2, slots), max_queue=max_queue,
            prefix_cache_bytes=prefix_cache_bytes),
        metrics=metrics, device=device) for i in range(n)]

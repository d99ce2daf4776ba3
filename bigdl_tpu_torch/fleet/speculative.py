"""Speculative decoding: a small draft model proposes, the target
verifies k tokens in ONE batched forward (counterpart of
``bigdl_tpu.fleet.speculative``).

A **draft** model runs ``k`` decode steps proposing ``d_1..d_k`` (each a
ragged-decode kernel launch a layer on the card), then the **target**
adjudicates all of them in one ``[slots, k]`` cached forward
(:meth:`~bigdl_tpu_torch.generation.engine.DecodeEngine.verify_program`,
the masked path: one extra program a rung, so the target holds at most
3 programs a (version, bucket) and the draft at most 2).

Acceptance rules:

- **greedy** (``temperature <= 0``): accept ``d_i`` iff it equals the
  target's argmax at that position; at the first mismatch emit the
  target's argmax instead. Every emitted token is a target argmax over
  committed context, so the stream equals target-only greedy decode
  token for token; the draft changes only the speed;
- **seeded sampling**: rejection sampling — accept ``d_i`` with
  probability ``min(1, p(d_i) / q(d_i))`` (``p`` the target's and
  ``q`` the draft's distribution under the same policy,
  :meth:`~bigdl_tpu_torch.generation.sampling.Sampler.probs`); on a
  rejection draw from the normalized residual ``max(p - q, 0)``. Every
  draw rides the request's one seeded PCG64 stream, so one seed gives
  one stream, and given equal logits the JAX package's.

The accepted-token rate is in ``fleet/speculative/*``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from bigdl_tpu_torch import faults, telemetry
from bigdl_tpu_torch.generation.engine import DecodeEngine
from bigdl_tpu_torch.generation.kv_cache import KVCache
from bigdl_tpu_torch.generation.sampling import Sampler, SamplingParams
from bigdl_tpu_torch.serving.compile_cache import BucketLadder, CompileCache
from bigdl_tpu_torch.serving.registry import Servable
from bigdl_tpu_torch.utils.engine import model_device, resolve_device

__all__ = ["SpeculativeConfig", "SpeculativeDecoder",
           "register_speculative_instruments"]


def register_speculative_instruments(r) -> Dict[str, object]:
    """Get-or-create the ``fleet/speculative/*`` instruments in registry
    ``r``."""
    return {
        "proposed": r.counter(
            "fleet/speculative/proposed",
            "draft tokens proposed for target verification"),
        "accepted": r.counter(
            "fleet/speculative/accepted",
            "draft proposals the target accepted"),
        "steps": r.counter(
            "fleet/speculative/steps",
            "verify macro-steps run (one batched target forward each)"),
        "accept_rate": r.gauge(
            "fleet/speculative/accept_rate",
            "accepted / proposed draft tokens (cumulative)"),
    }


@dataclass
class SpeculativeConfig:
    """Tuning surface for :class:`SpeculativeDecoder`.

    ``k`` is the draft width: proposals per macro step AND the verify
    program's token width (fixed per decoder, so each rung has one
    verify program). ``slots`` bounds the sequences of one
    :meth:`~SpeculativeDecoder.generate` call. A prompt must satisfy
    ``len(prompt) + max_new_tokens + k <= max_len`` (the verify step
    writes up to ``k`` rows past the committed length)."""
    k: int = 4
    slots: int = 4
    max_len: int = 256
    length_buckets: Optional[Sequence[int]] = None
    prefill_rows: int = 4
    eos_token: Optional[int] = None


class SpeculativeDecoder:
    """Batched draft-propose / target-verify decoding over the bucketed
    KV-cache engine (module docstring has the algorithm).

    One :class:`DecodeEngine` serves both models (programs are keyed
    per servable): the target builds prefill and verify programs, the
    draft prefill and decode programs, counted through one
    :class:`CompileCache`. Both models must live on ``device`` (the
    card by default)."""

    def __init__(self, model: torch.nn.Module, draft_model: torch.nn.Module,
                 config: Optional[SpeculativeConfig] = None, *,
                 name: str = "spec", metrics=None, compile_cache=None,
                 device: Optional[Union[str, torch.device]] = None):
        tv = int(getattr(model, "vocab_size", 0))
        dv = int(getattr(draft_model, "vocab_size", -1))
        if tv != dv:
            raise ValueError(
                f"target and draft must share one vocabulary "
                f"(got {tv} vs {dv}): acceptance compares per-token "
                "distributions index for index")
        self.device = resolve_device(device)
        for which, m in (("target", model), ("draft", draft_model)):
            dev = model_device(m)
            if dev.type != self.device.type:
                raise ValueError(f"the {which} model is on {dev}, the "
                                 f"decoder on {self.device}")
        self.config = config or SpeculativeConfig()
        if self.config.k < 1:
            raise ValueError(f"k must be >= 1, got {self.config.k}")
        self._name = name
        self.ladder = BucketLadder(self.config.max_len,
                                   self.config.length_buckets)
        self.cache = compile_cache if compile_cache is not None \
            else CompileCache()
        self.engine = DecodeEngine(self.cache, self.ladder,
                                   self.config.slots,
                                   min(self.config.prefill_rows,
                                       self.config.slots))
        self.target = Servable(f"{name}-target", 1, model)
        self.draft = Servable(f"{name}-draft", 1, draft_model)
        self._target_kv = KVCache.for_model(model, self.config.slots,
                                            self.config.max_len,
                                            device=self.device)
        self._draft_kv = KVCache.for_model(draft_model, self.config.slots,
                                           self.config.max_len,
                                           device=self.device)
        r = metrics if metrics is not None else telemetry.REGISTRY
        inst = register_speculative_instruments(r)
        self._c_proposed = inst["proposed"]
        self._c_accepted = inst["accepted"]
        self._c_steps = inst["steps"]
        self._g_rate = inst["accept_rate"]
        self._labels = {"model": name}
        self._proposed_total = 0
        self._accepted_total = 0

    # ------------------------------------------------------- lifecycle
    def compile_count(self) -> int:
        """Programs built for the target + draft pair (the quantity the
        ≤ 3 + ≤ 2 per-bucket bound is asserted on)."""
        return (self.engine.compile_count(self.target)
                + self.engine.compile_count(self.draft))

    # -------------------------------------------------------- generate
    def generate(self, prompts: Sequence, max_new_tokens: int,
                 sampling: Optional[SamplingParams] = None):
        """Decode every prompt to ``max_new_tokens`` (or EOS) with
        draft speculation; returns ``(outputs, stats)``: int32 token
        arrays, and the run's proposal / acceptance accounting. Request
        ``i`` samples from seed ``sampling.seed + i``. A run that raises
        frees its slots for the next call."""
        cfg = self.config
        n = len(prompts)
        if not 1 <= n <= cfg.slots:
            raise ValueError(f"{n} prompts for {cfg.slots} slots")
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        base = (sampling or SamplingParams()).validate()
        greedy = base.temperature <= 0.0
        for p in prompts:
            if p.shape[0] < 1:
                raise ValueError("prompt needs >= 1 tokens")
            if p.shape[0] + max_new_tokens + cfg.k > cfg.max_len:
                raise ValueError(
                    f"prompt of {p.shape[0]} + max_new={max_new_tokens} "
                    f"+ k={cfg.k} overruns the max_len={cfg.max_len} "
                    "cache (the verify step writes k rows past the "
                    "committed length)")
        samplers = [Sampler(replace(base, seed=base.seed + i))
                    for i in range(n)]

        t_kv, d_kv = self._target_kv, self._draft_kv
        slots = [t_kv.allocator.alloc() for _ in range(n)]
        try:
            return self._run(prompts, max_new_tokens, samplers, greedy,
                             slots)
        finally:
            for s in slots:
                t_kv.lengths[s] = 0
                t_kv.allocator.free(s)
                d_kv.lengths[s] = 0

    def _run(self, prompts, max_new, samplers, greedy, slots):
        cfg = self.config
        t_kv, d_kv = self._target_kv, self._draft_kv
        n, w = len(prompts), cfg.k
        # --- prefill both caches (in prefill-batch pieces) -------------
        first_logits: List[Optional[np.ndarray]] = [None] * n
        rows = self.engine.prefill_rows
        for lo in range(0, n, rows):
            piece = list(range(lo, min(lo + rows, n)))
            logits, _ = self.engine.prefill(
                self.target, t_kv, [prompts[i] for i in piece],
                [slots[i] for i in piece])
            for j, i in enumerate(piece):
                first_logits[i] = logits[j]
            self.engine.prefill(self.draft, d_kv,
                                [prompts[i] for i in piece],
                                [slots[i] for i in piece])
        for i in range(n):
            d_kv.lengths[slots[i]] = t_kv.lengths[slots[i]]

        emitted: List[List[int]] = [[] for _ in range(n)]
        last = np.zeros((t_kv.slots,), np.int32)
        active = np.zeros((t_kv.slots,), bool)
        by_slot = {slots[i]: i for i in range(n)}
        for i in range(n):
            tok = samplers[i].sample(first_logits[i])
            emitted[i].append(int(tok))
            last[slots[i]] = tok
            active[slots[i]] = not self._done(emitted[i], max_new,
                                              cfg.eos_token)

        proposed = accepted = steps = 0
        while active.any():
            steps += 1
            live = [int(s) for s in np.flatnonzero(active)]
            # --- the draft proposes w tokens per live slot -------------
            proposals = np.zeros((t_kv.slots, w), np.int32)
            qrows: List[List] = [[None] * w for _ in range(t_kv.slots)]
            prev = last.copy()
            for j in range(w):
                tokens = np.where(active, prev, 0).astype(np.int32)
                dlog, _ = self.engine.decode(self.draft, d_kv, tokens,
                                             d_kv.lengths, active)
                for s in live:
                    i = by_slot[s]
                    if greedy:
                        d = int(np.argmax(dlog[s]))
                    else:
                        q = samplers[i].probs(dlog[s])
                        qrows[s][j] = q
                        d = samplers[i].draw(q)
                    proposals[s, j] = d
                    prev[s] = d
                    d_kv.lengths[s] += 1
            # --- the target adjudicates all w in ONE forward -----------
            tok_mat = np.zeros((t_kv.slots, w), np.int32)
            for s in live:
                tok_mat[s, 0] = last[s]
                if w > 1:
                    tok_mat[s, 1:] = proposals[s, :w - 1]
            faults.point("fleet/verify", model=self._name,
                         slots=len(live))
            vlog, _ = self.engine.verify(self.target, t_kv, tok_mat,
                                         t_kv.lengths, active)
            # --- accept / correct, on the host -------------------------
            for s in live:
                i = by_slot[s]
                a = 0
                for j in range(w):
                    row, d = vlog[s, j], int(proposals[s, j])
                    if greedy:
                        choice = int(np.argmax(row))
                        ok = d == choice
                        token = d if ok else choice
                    else:
                        p = samplers[i].probs(row)
                        q = qrows[s][j]
                        u = samplers[i].uniform()
                        ok = q[d] > 0.0 and u < min(1.0, p[d] / q[d])
                        if ok:
                            token = d
                        else:
                            resid = np.maximum(p - q, 0.0)
                            tot = resid.sum()
                            token = samplers[i].draw(
                                resid / tot if tot > 0.0 else p)
                    if ok:
                        a += 1
                    if not self._done(emitted[i], max_new, cfg.eos_token):
                        emitted[i].append(int(token))
                    last[s] = token
                    if not ok:
                        break
                committed = w if a == w else a + 1
                t_kv.lengths[s] += committed
                d_kv.lengths[s] = t_kv.lengths[s]
                proposed += w
                accepted += a
                if self._done(emitted[i], max_new, cfg.eos_token):
                    active[s] = False
        self._account(proposed, accepted, steps)
        stats = {"proposed": proposed, "accepted": accepted,
                 "macro_steps": steps,
                 "accept_rate": accepted / proposed if proposed else 0.0,
                 "tokens": sum(len(e) for e in emitted)}
        return [np.asarray(e, np.int32) for e in emitted], stats

    # --------------------------------------------------------- helpers
    @staticmethod
    def _done(emitted: List[int], max_new: int,
              eos: Optional[int]) -> bool:
        return len(emitted) >= max_new \
            or (eos is not None and bool(emitted) and emitted[-1] == eos)

    def _account(self, proposed: int, accepted: int, steps: int) -> None:
        if proposed:
            self._c_proposed.inc(proposed, **self._labels)
            self._c_accepted.inc(accepted, **self._labels)
        if steps:
            self._c_steps.inc(steps, **self._labels)
        self._proposed_total += proposed
        self._accepted_total += accepted
        if self._proposed_total:
            self._g_rate.set(self._accepted_total / self._proposed_total,
                             **self._labels)

    def stats(self) -> Dict[str, float]:
        """Cumulative proposal/acceptance accounting across calls."""
        return {"proposed": self._proposed_total,
                "accepted": self._accepted_total,
                "accept_rate": (self._accepted_total
                                / self._proposed_total
                                if self._proposed_total else 0.0)}

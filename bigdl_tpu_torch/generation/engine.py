"""Prefill/decode programs, bucketed by sequence length (counterpart of
``bigdl_tpu.generation.engine``).

Every shape is pinned to a rung of the service's
:class:`~bigdl_tpu_torch.serving.compile_cache.BucketLadder`:

- **prefill** runs at ``[prefill_rows, S_b]`` for the prompt bucket
  ``S_b``: the padded-prompt batch computes the prompts' K/V rows and
  the first-token logits in one call and writes the rows of the real
  prompts into their slots (padding rows write nothing). With
  ``prefill_chunk`` (long context), a rung past the chunk fills in
  ``[prefill_rows, chunk]`` pieces through the SAME one program per
  rung, each attending what the earlier chunks wrote;
- **decode** runs at ``[slots]`` — one token per slot per step — with
  attention restricted to the first ``T_b`` cache positions for the
  bucket ``T_b`` of the longest live row, and each slot's attention
  reading only its own ``length + 1`` rows (the ragged decode kernel).

K rungs ⇒ at most K prefill + K decode = 2K programs per model version,
built eagerly as pairs by :meth:`DecodeEngine.warmup` and counted
through the shared :class:`CompileCache`. A program here is a Python
callable over device tensors (the JAX package's is a jitted function);
the bound keeps the per-rung structure a later change captures as CUDA
graphs.

Speculative decoding (:mod:`bigdl_tpu_torch.fleet.speculative`) adds one
**verify** program per rung — ``[slots, w]`` draft tokens through the
same cached forward, on its masked path (no kernel: the ragged kernel
takes one query a slot) — so the bound is **at most 3 programs per
(version, bucket)**: prefill, decode, verify, asserted at registration.
``prefill(start=)`` skips the chunks a prefix-cache seed already wrote
(:mod:`bigdl_tpu_torch.fleet.prefix`).

Not ported yet: the static-verifier hook (``abstract_programs``, with
the analysis slice).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.generation.kv_cache import KVCache
from bigdl_tpu_torch.serving.compile_cache import BucketLadder, CompileCache

__all__ = ["DecodeEngine"]


class DecodeEngine:
    """Per-servable prefill/decode programs over one length ladder.

    Stateless apart from the program handles it registers in the shared
    :class:`CompileCache` (keys ``servable.key + ("prefill", S_b)`` /
    ``+ ("decode", T_b)``); the caller owns the :class:`KVCache` and
    passes it in."""

    def __init__(self, cache: CompileCache, ladder: BucketLadder,
                 slots: int, prefill_rows: int,
                 prefill_chunk: Optional[int] = None):
        self.cache = cache
        self.ladder = ladder
        self.slots = slots
        self.prefill_rows = prefill_rows
        # chunked prefill (long-context serving): prompts whose rung
        # exceeds ``prefill_chunk`` prefill in fixed [rows, chunk]
        # pieces against that rung's attend window — still ONE prefill
        # program per rung, so the <= 2-per-rung bound holds. The chunk
        # must divide every larger rung, else chunk starts drift off
        # the attend window.
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk={prefill_chunk} "
                                 f"must be >= 1")
            for rung in ladder:
                if rung > prefill_chunk and rung % prefill_chunk:
                    raise ValueError(
                        f"prefill_chunk={prefill_chunk} must divide "
                        f"every larger ladder rung (rung {rung})")
        self.prefill_chunk = prefill_chunk
        # program keys per servable key, so unload drops exactly the
        # programs this engine created; the decode thread registers
        # while metrics readers iterate
        self._lock = threading.Lock()
        self._keys: Dict[Tuple, Set[Tuple]] = {}

    # ------------------------------------------------------- programs
    #: the program kinds of a ladder rung: the documented
    #: ≤ 3-programs-per-(version, bucket) bound
    _KINDS = frozenset({"prefill", "decode", "verify"})

    def _program(self, servable, kind: str, bucket: int, build):
        key = servable.key + (kind, bucket)
        prog = self.cache.program_for(key, build)
        with self._lock:
            keys = self._keys.setdefault(servable.key, set())
            keys.add(key)
            kinds = {k[-2] for k in keys if k[-1] == bucket}
            assert kinds <= self._KINDS and len(kinds) <= 3, \
                (f"program kinds {sorted(kinds)} for bucket {bucket} "
                 f"break the ≤3-per-(version, bucket) bound")
        return prog

    @staticmethod
    def _prefill_fn(model, slots: int, attend_len: int):
        """``(k, v, tokens[Bp,Sq], last_in_chunk[Bp], slot_ids[Bp],
        offsets[Bp], real_rows) -> logits[Bp, V]`` (each row's logits at
        its last token in this chunk). ``tokens`` is one chunk of each
        row's prompt (the whole prompt when ``Sq`` is the rung), placed
        at cache position ``offsets``: each row's slot window
        ``[:attend_len]`` is gathered (the out-of-range padding id
        clamps to the last slot), so the chunk attends what earlier
        chunks wrote there, run through the cached forward at its
        offset, and only ``real_rows`` are written back — torch has no
        scatter that drops out-of-range ids, so padding rows are kept
        out of the write explicitly."""
        def fn(k, v, tokens, last_in_chunk, slot_ids, offsets, real_rows):
            ids = slot_ids.clamp(max=slots - 1)
            rows_k = k[:, ids, :, :attend_len, :]
            rows_v = v[:, ids, :, :attend_len, :]
            logits = model(tokens, cache={"k": rows_k, "v": rows_v},
                           positions=offsets, attend_len=attend_len)
            rows = torch.arange(tokens.shape[0], device=logits.device)
            last = logits[rows, last_in_chunk.long() - 1]
            if real_rows.numel():
                dst = slot_ids[real_rows]
                k[:, dst, :, :attend_len, :] = rows_k[:, real_rows]
                v[:, dst, :, :attend_len, :] = rows_v[:, real_rows]
            return last

        return fn

    @staticmethod
    def _decode_fn(model, attend_len: int):
        """``(k, v, tokens[slots], positions[slots]) -> logits[slots,
        V]``: each slot writes its token's K/V at ``positions[s]`` and
        attends its first ``positions[s] + 1`` cache rows (positions of
        inactive slots are 0: they write into their own free row, which
        the slot's next prefill rewrites before anything attends it)."""
        def fn(k, v, tokens, positions):
            logits = model(tokens[:, None], cache={"k": k, "v": v},
                           positions=positions, attend_len=attend_len)
            return logits[:, 0, :]

        return fn

    @staticmethod
    def _verify_fn(model, attend_len: int):
        """``(k, v, tokens[slots, w], positions[slots]) -> logits[slots,
        w, V]``: row ``s`` writes K/V for its ``w`` tokens at
        ``positions[s] .. positions[s] + w - 1`` and ``logits[s, i]`` is
        the distribution of the token AFTER input ``i``, through the
        cached forward's masked path."""
        def fn(k, v, tokens, positions):
            return model(tokens, cache={"k": k, "v": v},
                         positions=positions, attend_len=attend_len)

        return fn

    def prefill_program(self, servable, bucket: int):
        """The prefill program for prompt bucket ``bucket``; its token
        width is :meth:`chunk_for` the bucket."""
        model = servable.model
        return self._program(
            servable, "prefill", bucket,
            lambda: self._prefill_fn(model, self.slots, bucket))

    def chunk_for(self, bucket: int) -> int:
        """The prefill token width for ``bucket``: the bucket itself,
        or the fixed chunk for rungs past ``prefill_chunk``."""
        if self.prefill_chunk is None or bucket <= self.prefill_chunk:
            return bucket
        return self.prefill_chunk

    def decode_program(self, servable, attend_len: int):
        """The decode step for length bucket ``attend_len``."""
        model = servable.model
        return self._program(
            servable, "decode", attend_len,
            lambda: self._decode_fn(model, attend_len))

    def verify_program(self, servable, attend_len: int):
        """The speculative-verify step for length bucket ``attend_len``
        (the third and last program kind of a rung; ``w`` is fixed per
        decoder, so one verify program a rung)."""
        model = servable.model
        return self._program(
            servable, "verify", attend_len,
            lambda: self._verify_fn(model, attend_len))

    # ------------------------------------------------------ execution
    @staticmethod
    def _to_device(kv: KVCache, *arrays: np.ndarray):
        """Host int32 vectors → one stacked host-to-device copy."""
        stacked = torch.from_numpy(np.stack(
            [np.asarray(a, np.int32) for a in arrays]))
        return stacked.to(kv.device).unbind(0)

    def prefill(self, servable, kv: KVCache, prompts: Sequence[np.ndarray],
                slot_ids: Sequence[int],
                start: Optional[Sequence[int]] = None):
        """Run one padded-prompt prefill batch: writes each prompt's K/V
        into its slot's cache rows and returns the ``[n, V]``
        last-prompt-token logits (host ndarray) for the ``n`` real rows,
        plus the bucket. Prompts pad to the rung of the longest one;
        rows pad to ``prefill_rows`` with the out-of-range slot id
        ``slots``. Past ``prefill_chunk`` the rung fills chunk by chunk
        through the same program: row ``i`` rides chunk ``c`` while it
        has tokens there and its seeded prefix does not cover the chunk
        (else its id is out of range and it writes nothing), and its
        logits come from the chunk holding its last prompt token.
        ``start[i]`` (a chunk multiple below the prompt length; a
        prefix-cache seed wrote the rows before it) skips the chunks
        before it."""
        n = len(prompts)
        if n == 0 or n > self.prefill_rows:
            raise ValueError(f"prefill batch of {n} rows "
                             f"(prefill_rows={self.prefill_rows})")
        lens = [len(p) for p in prompts]
        bucket = self.ladder.bucket_for(max(lens))
        sq = self.chunk_for(bucket)
        starts = [0] * n if start is None else [int(s0) for s0 in start]
        for i, s0 in enumerate(starts):
            if s0 % sq or not 0 <= s0 < lens[i]:
                raise ValueError(
                    f"start[{i}]={s0} must be a chunk multiple "
                    f"(chunk {sq}) below the prompt length {lens[i]}")
        prog = self.prefill_program(servable, bucket)
        out = [None] * n
        with torch.no_grad():
            for c in range(bucket // sq):
                off = c * sq
                tokens = np.zeros((self.prefill_rows, sq), np.int32)
                last_in = np.ones((self.prefill_rows,), np.int32)
                ids = np.full((self.prefill_rows,), self.slots,
                              np.int32)  # out of range: writes nothing
                offsets = np.zeros((self.prefill_rows,), np.int32)
                live = [i for i in range(n)
                        if lens[i] > off and starts[i] <= off]
                if not live:
                    continue
                for i in live:
                    piece = np.asarray(prompts[i][off:off + sq], np.int32)
                    tokens[i, :len(piece)] = piece
                    last_in[i] = min(lens[i] - off, sq)
                    ids[i] = slot_ids[i]
                    offsets[i] = off
                d_last, d_ids, d_off = self._to_device(kv, last_in, ids,
                                                       offsets)
                d_tokens = torch.from_numpy(tokens).to(kv.device)
                real = torch.tensor(live, dtype=torch.long,
                                    device=kv.device)
                logits = prog(kv.k, kv.v, d_tokens, d_last, d_ids, d_off,
                              real)
                done = [i for i in live if (lens[i] - 1) // sq == c]
                if done:
                    host = logits[done].float().cpu().numpy()
                    for j, i in enumerate(done):
                        out[i] = host[j]
        for i, slot in enumerate(slot_ids):
            kv.lengths[slot] = lens[i]
        return np.stack(out), bucket

    def decode(self, servable, kv: KVCache, tokens: np.ndarray,
               positions: np.ndarray, active: np.ndarray):
        """Run one decode step over every slot (one token per live
        slot); returns the ``[slots, V]`` logits as a host ndarray and
        the attend bucket, re-chosen from the longest live row each
        step. ``positions`` is the host per-slot lengths vector
        (``kv.lengths`` for live slots): it is the ragged kernel's
        length operand, so the kernel adds no program keys."""
        longest = int(positions[active].max()) + 1 if active.any() else 1
        attend_len = self.ladder.bucket_for(longest)
        prog = self.decode_program(servable, attend_len)
        pos = np.where(active, positions, 0)
        with torch.no_grad():
            d_tokens, d_pos = self._to_device(kv, tokens, pos)
            logits = prog(kv.k, kv.v, d_tokens, d_pos)
            # sampling is host numpy: the [slots, V] row block comes
            # back every step
            out = logits.float().cpu().numpy()
        return out, attend_len

    def verify(self, servable, kv: KVCache, tokens: np.ndarray,
               positions: np.ndarray, active: np.ndarray):
        """Run one speculative-verify step (``tokens`` is ``[slots,
        w]``); returns the ``[slots, w, V]`` logits as a host ndarray
        and the attend bucket, which covers the deepest write
        (``positions + w``) of the longest live row."""
        w = int(tokens.shape[1])
        longest = int(positions[active].max()) + w if active.any() else w
        attend_len = self.ladder.bucket_for(longest)
        prog = self.verify_program(servable, attend_len)
        pos = np.where(active, positions, 0)
        with torch.no_grad():
            d_pos, = self._to_device(kv, pos)
            d_tokens = torch.from_numpy(
                np.asarray(tokens, np.int32)).to(kv.device)
            logits = prog(kv.k, kv.v, d_tokens, d_pos)
            out = logits.float().cpu().numpy()
        return out, attend_len

    # -------------------------------------------------------- warmup
    def warmup(self, servable, kv: KVCache) -> int:
        """Build and run the prefill+decode pair for every ladder rung
        before the version takes traffic. Every write is dropped or
        lands in a free slot's row, so ``kv`` stays servable (the
        service passes the cache the decode loop will adopt). Returns
        how many programs this call built (≤ 2 × rungs)."""
        before = self.compile_count(servable)
        drop_ids = np.full((self.prefill_rows,), self.slots, np.int32)
        ones = np.ones((self.prefill_rows,), np.int32)
        zeros_p = np.zeros((self.prefill_rows,), np.int32)
        zeros_s = np.zeros((self.slots,), np.int32)
        with torch.no_grad():
            d_last, d_ids, d_off = self._to_device(kv, ones, drop_ids,
                                                   zeros_p)
            d_tok, d_pos = self._to_device(kv, zeros_s, zeros_s)
            none = torch.zeros((0,), dtype=torch.long, device=kv.device)
            for rung in self.ladder:
                pre = self.prefill_program(servable, rung)
                # the token width serving feeds this rung: the chunk for
                # rungs past prefill_chunk
                prompts = torch.zeros((self.prefill_rows,
                                       self.chunk_for(rung)),
                                      dtype=torch.int32, device=kv.device)
                pre(kv.k, kv.v, prompts, d_last, d_ids, d_off, none)
                dec = self.decode_program(servable, rung)
                dec(kv.k, kv.v, d_tok, d_pos)
            if kv.device.type == "cuda":
                torch.cuda.synchronize(kv.device)
        return self.compile_count(servable) - before

    # ----------------------------------------------------- accounting
    def compile_count(self, servable) -> int:
        """Programs built for this servable through this engine."""
        with self._lock:
            keys = list(self._keys.get(servable.key, ()))
        return sum(self.cache.compile_count(k) for k in keys)

    def drop(self, key: Tuple) -> None:
        """Release every program registered for a servable key."""
        with self._lock:
            keys = self._keys.pop(key, ())
        for k in keys:
            self.cache.drop(k)

"""The tuned-config artifact: versioned, fingerprinted ``tuned.json``
(counterpart of ``bigdl_tpu.autotune.config``).

A sweep's output is configuration, so it gets a checkpoint's rigor: a
schema version readers validate, the full leaderboard, the pruned log
and an **environment fingerprint** (device kind, platform, device count,
mesh shape, package version). A consumer —
:func:`~bigdl_tpu_torch.generation.service.apply_tuned_config` — refuses
an artifact whose fingerprint differs from the running environment's
with a typed :class:`FingerprintMismatchError`, unless the caller passes
``allow_mismatch`` or a ``fingerprint`` to check against. The file
format is the JAX package's, byte for byte: an artifact either package
wrote loads in the other.

Serialization is canonical (sorted keys, indent 2, trailing newline),
so equal sweeps are equal bytes.

:func:`apply_tuned_optimizer` applies an artifact's train winner onto a
live ``Optimizer`` through its own setters. Not ported yet: the sweep
itself and ``apply_to_perf_args`` (the tools, ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["TUNED_SCHEMA_VERSION", "TunedConfigError",
           "apply_tuned_optimizer",
           "FingerprintMismatchError", "Fingerprint", "TunedConfig",
           "save_tuned", "load_tuned"]

#: bump when the artifact layout changes; readers refuse unknown
#: versions instead of guessing
TUNED_SCHEMA_VERSION = 1


class TunedConfigError(ValueError):
    """A tuned.json artifact is malformed or has an unknown schema."""


class FingerprintMismatchError(TunedConfigError):
    """The artifact was tuned on a different environment than the one
    trying to apply it. Carries the per-field differences."""

    def __init__(self, mismatches: Dict[str, Tuple[object, object]]):
        self.mismatches = dict(mismatches)
        detail = "; ".join(
            f"{k}: artifact={a!r} vs running={b!r}"
            for k, (a, b) in sorted(self.mismatches.items()))
        super().__init__(
            f"tuned.json fingerprint mismatch ({detail}) — re-run "
            f"the autotuner on this environment "
            f"or pass allow_mismatch=True to inspect anyway")


@dataclass(frozen=True)
class Fingerprint:
    """The environment a tuned artifact is valid for."""

    device_kind: str
    platform: str
    device_count: int
    mesh_shape: Tuple[int, ...]
    package_version: str

    @classmethod
    def current(cls) -> "Fingerprint":
        """Fingerprint of the running process, read from torch: the
        first card's name and ``"gpu"`` with the card count, or
        ``"cpu"`` and 1 without CUDA; the mesh shape is the flat device
        count; the port's package version."""
        import torch

        import bigdl_tpu_torch

        if torch.cuda.is_available():
            count = torch.cuda.device_count()
            kind, platform = torch.cuda.get_device_name(0), "gpu"
        else:
            count, kind, platform = 1, "cpu", "cpu"
        return cls(device_kind=kind, platform=platform,
                   device_count=count, mesh_shape=(count,),
                   package_version=bigdl_tpu_torch.__version__)

    def to_dict(self) -> Dict[str, object]:
        """JSON-ready form."""
        return {"device_kind": self.device_kind,
                "platform": self.platform,
                "device_count": self.device_count,
                "mesh_shape": list(self.mesh_shape),
                "package_version": self.package_version}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Fingerprint":
        """Parse; raises :class:`TunedConfigError` on missing keys."""
        try:
            return cls(device_kind=str(d["device_kind"]),
                       platform=str(d["platform"]),
                       device_count=int(d["device_count"]),
                       mesh_shape=tuple(int(x)
                                        for x in d["mesh_shape"]),
                       package_version=str(d["package_version"]))
        except (KeyError, TypeError, ValueError) as e:
            raise TunedConfigError(
                f"invalid fingerprint block: {e!r}") from e

    def mismatches(self, other: "Fingerprint"
                   ) -> Dict[str, Tuple[object, object]]:
        """Field-by-field differences vs ``other`` (empty = match)."""
        out: Dict[str, Tuple[object, object]] = {}
        for k in ("device_kind", "platform", "device_count",
                  "mesh_shape", "package_version"):
            a, b = getattr(self, k), getattr(other, k)
            if a != b:
                out[k] = (a, b)
        return out


@dataclass
class TunedConfig:
    """One sweep's result: winners per regime, the full leaderboard,
    the pruned log, the fingerprint and the seed that produced it."""

    fingerprint: Fingerprint
    seed: int
    #: regime -> winning config dict (axis name -> value)
    winners: Dict[str, Dict[str, object]] = field(default_factory=dict)
    #: regime -> objective name ("train_steps_per_sec" / ...)
    objectives: Dict[str, str] = field(default_factory=dict)
    #: every measured candidate: {cid, regime, config, objective, ok,
    #: error} sorted best-first per regime
    leaderboard: List[Dict[str, object]] = field(default_factory=list)
    #: every statically dropped candidate: {candidate, stage, reason}
    pruned: List[Dict[str, object]] = field(default_factory=list)
    #: recorded policy decisions, e.g. {"flash_attention": {...}}
    decisions: Dict[str, object] = field(default_factory=dict)
    schema_version: int = TUNED_SCHEMA_VERSION

    def winner(self, regime: str) -> Dict[str, object]:
        """The winning config for ``regime``; typed error if the sweep
        never measured that regime."""
        try:
            return self.winners[regime]
        except KeyError:
            raise TunedConfigError(
                f"tuned.json has no {regime!r} winner (regimes: "
                f"{sorted(self.winners) or 'none'})") from None

    def to_json(self) -> str:
        """Canonical serialization — sorted keys, indent 2, trailing
        newline — so equal sweeps are equal BYTES."""
        payload = {
            "schema_version": self.schema_version,
            "fingerprint": self.fingerprint.to_dict(),
            "seed": self.seed,
            "winners": self.winners,
            "objectives": self.objectives,
            "leaderboard": self.leaderboard,
            "pruned": self.pruned,
            "decisions": self.decisions,
        }
        return json.dumps(payload, sort_keys=True, indent=2) + "\n"


def save_tuned(cfg: TunedConfig, path: str) -> str:
    """Write the artifact atomically (tmp + rename); returns ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(cfg.to_json())
    os.replace(tmp, path)
    return path


def _tuplify(cfg: Dict[str, object]) -> Dict[str, object]:
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in cfg.items()}


def load_tuned(path: str, *, fingerprint: Optional[Fingerprint] = None,
               allow_mismatch: bool = False) -> TunedConfig:
    """Load + validate a ``tuned.json``: schema version must be known,
    the fingerprint block must parse, and unless ``allow_mismatch`` the
    artifact's fingerprint must equal the running environment's
    (``fingerprint`` overrides :meth:`Fingerprint.current`, for tests).
    Raises :class:`TunedConfigError` / :class:`FingerprintMismatchError`.
    """
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise TunedConfigError(f"cannot read tuned.json at "
                               f"{path!r}: {e}") from e
    if not isinstance(raw, dict):
        raise TunedConfigError("tuned.json root must be an object")
    version = raw.get("schema_version")
    if version != TUNED_SCHEMA_VERSION:
        raise TunedConfigError(
            f"unknown tuned.json schema_version {version!r} "
            f"(this build reads {TUNED_SCHEMA_VERSION})")
    for key in ("fingerprint", "seed", "winners"):
        if key not in raw:
            raise TunedConfigError(f"tuned.json missing {key!r}")
    artifact_fp = Fingerprint.from_dict(raw["fingerprint"])
    running = fingerprint or Fingerprint.current()
    diff = artifact_fp.mismatches(running)
    if diff and not allow_mismatch:
        raise FingerprintMismatchError(diff)
    winners = {r: _tuplify(dict(c))
               for r, c in dict(raw["winners"]).items()}
    return TunedConfig(
        fingerprint=artifact_fp, seed=int(raw["seed"]),
        winners=winners,
        objectives=dict(raw.get("objectives", {})),
        leaderboard=list(raw.get("leaderboard", [])),
        pruned=list(raw.get("pruned", [])),
        decisions=dict(raw.get("decisions", {})),
        schema_version=int(version))


def apply_tuned_optimizer(cfg: TunedConfig, optimizer):
    """Apply the train winner onto a live ``Optimizer`` through its own
    setters (``set_steps_per_sync`` / ``set_zero`` / ``set_precision``),
    in the JAX package's order: the artifact configures, it never
    bypasses."""
    winner = cfg.winner("train")
    if "steps_per_sync" in winner:
        optimizer.set_steps_per_sync(int(winner["steps_per_sync"]))
    if "zero_stage" in winner:
        from bigdl_tpu_torch.parallel import ZeroConfig

        stage = int(winner["zero_stage"])
        optimizer.set_zero(ZeroConfig(stage=stage) if stage else None)
    if "precision" in winner:
        prec = winner["precision"]
        optimizer.set_precision(None if prec == "f32" else prec)
    return optimizer

"""Multi-model registry: named, versioned servables with atomic hot-swap
(counterpart of ``bigdl_tpu.serving.registry``).

A servable is one ``(name, version, model)``; ``current()`` returns one
object and a swap republishes the name→servable pointer under the
registry lock, so work already dispatched keeps the snapshot it
resolved and later work sees only the new one. A swap passes the
``serving/swap`` fault point first: a fault there leaves the old version
current.

The JAX package snapshots immutable params at load; a torch module is
mutable, so the registry holds the module itself and the caller must
not train it while it serves. ``quantize=True`` registers the int8
rewrite instead (:func:`bigdl_tpu_torch.nn.quantized.quantize`, a new
tree), optionally calibrated (``calibration=``) and certified against
the float model by an accuracy gate (``accuracy_gate=``) before
anything is staged.

``path=`` loads a module saved by either package's ``save_module``
(:func:`bigdl_tpu_torch.utils.serialization.load_module`) onto
``device`` and registers it in evaluation mode.

Not ported yet: the pre-flight shape check (``input_spec=``, with the
analysis slice); it raises NotImplementedError.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from torch import nn

from bigdl_tpu_torch import faults

__all__ = ["ModelRegistry", "Servable"]


class Servable:
    """One ``(model)`` snapshot behind a ``(name, version)``."""

    __slots__ = ("name", "version", "model")

    def __init__(self, name: str, version: int, model: nn.Module):
        self.name = name
        self.version = version
        self.model = model

    @property
    def key(self):
        """Program-cache key: programs are never shared across
        versions."""
        return (self.name, self.version)

    def __repr__(self) -> str:
        return (f"Servable({self.name!r} v{self.version} "
                f"{type(self.model).__name__})")


class _Entry:
    def __init__(self):
        self.versions: Dict[int, Servable] = {}
        self.current: Optional[Servable] = None


class ModelRegistry:
    """Named models, each with versions and one *current* pointer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, _Entry] = {}

    def load(self, name: str, model: Optional[nn.Module] = None, *,
             path: Optional[str] = None, version: Optional[int] = None,
             quantize: bool = False, calibration=None, accuracy_gate=None,
             activate: bool = True, input_spec=None,
             device=None) -> Servable:
        """Register ``model`` as a version of ``name`` (the next free
        number by default), or the module saved at ``path``, loaded on
        ``device`` (the card by default) in evaluation mode. ``activate=False`` stages it only — even
        for a fresh name — so a caller can warm it before any traffic
        resolves it; :meth:`swap` makes it current.

        ``quantize=True`` registers the int8 rewrite of ``model`` (a new
        tree; ``model`` is untouched). ``calibration`` (an iterable of
        activation batches) runs the FLOAT model once over the batches
        and bakes per-layer static activation scales into the int8 twin.
        ``accuracy_gate`` (a :class:`~bigdl_tpu_torch.precision.
        AccuracyGate`) evaluates the quantized candidate against the
        float model BEFORE registration: a delta above the bound raises
        ``AccuracyGateError`` and stages nothing — the previous version
        keeps serving."""
        if (model is None) == (path is None):
            raise ValueError("pass exactly one of model= or path=")
        if path is not None:
            from bigdl_tpu_torch.utils.serialization import load_module
            # a fresh instance: the registry owns it
            model = load_module(path, device=device).eval()
        if input_spec is not None:
            raise NotImplementedError(
                "ModelRegistry.load(input_spec=): the pre-flight shape "
                "check waits for the port's analysis slice")
        if not isinstance(model, nn.Module):
            raise TypeError(f"model must be a torch.nn.Module, got "
                            f"{type(model).__name__}")
        if (calibration is not None or accuracy_gate is not None) \
                and not quantize:
            raise ValueError(
                "calibration=/accuracy_gate= only apply to quantize=True "
                "loads (they calibrate and certify the int8 rewrite)")
        if quantize:
            from bigdl_tpu_torch.nn.quantized import quantize as _quantize
            from bigdl_tpu_torch.precision.calibrate import maybe_collect

            float_reference = model
            model = _quantize(model, maybe_collect(model, calibration))
            if accuracy_gate is not None:
                # raises AccuracyGateError above the bound — before any
                # registration; the delta lands in the gauge either way
                accuracy_gate.check(float_reference, model, label=name)
        with self._lock:
            entry = self._models.setdefault(name, _Entry())
            if version is None:
                version = max(entry.versions, default=0) + 1
            if version in entry.versions:
                raise ValueError(f"{name} v{version} already loaded "
                                 "(unload it first or pick a new version)")
            servable = Servable(name, version, model)
            entry.versions[version] = servable
            if activate:
                entry.current = servable
        return servable

    def current(self, name: str) -> Servable:
        """The servable behind ``name`` right now."""
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(f"no model loaded under {name!r}")
            if entry.current is None:
                raise KeyError(
                    f"no ACTIVE version under {name!r} (versions "
                    f"{sorted(entry.versions)} are staged; swap one in)")
            return entry.current

    def swap(self, name: str, version: int) -> Servable:
        """Atomically repoint ``name`` at an already-loaded version."""
        # hot-swap failure site: a fault raised here leaves the OLD
        # version serving (the repoint below is the only mutation)
        faults.point("serving/swap", name=name, version=version)
        with self._lock:
            entry = self._models.get(name)
            if entry is None or version not in entry.versions:
                raise KeyError(f"{name!r} has no loaded v{version}")
            entry.current = entry.versions[version]
            return entry.current

    def unload(self, name: str, version: Optional[int] = None) -> List:
        """Drop one version (or the whole name); refuses the current
        version unless the whole name goes. Returns the dropped keys."""
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(f"no model loaded under {name!r}")
            if version is None:
                dropped = list(entry.versions.values())
                del self._models[name]
            else:
                if version not in entry.versions:
                    raise KeyError(f"{name!r} has no loaded v{version}")
                if entry.current is not None and \
                        entry.current.version == version:
                    raise ValueError(
                        f"{name} v{version} is the current servable; "
                        "swap to another version before unloading it")
                dropped = [entry.versions.pop(version)]
            return [s.key for s in dropped]

    def versions(self, name: str) -> List[int]:
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(f"no model loaded under {name!r}")
            return sorted(entry.versions)

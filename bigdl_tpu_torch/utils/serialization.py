"""Checkpoints and saved modules (counterpart of
``bigdl_tpu.utils.serialization``; BigDL utils/serializer and
utils/File.scala), in the JAX package's on-disk format, so a directory
written by either package loads in the other.

A tree (nested dicts and Tables with array leaves) is ``<prefix>.json``
(its structure, leaves as ``"__leaf__"``) and ``<prefix>.npz`` (the
leaves under their ``/``-joined paths). A checkpoint is a directory of
three trees (``params``, ``opt_state``, ``model_state``), a
``host_state.json`` and, written last, ``MANIFEST.json`` (format 2:
every file's sha256): staged in ``<path>.tmp-<pid>``, fsynced and
renamed into place, so a crash at any point leaves the previous complete
checkpoint or debris that :func:`find_latest_checkpoint` never selects.
A saved module is ``module.json`` (its topology,
:mod:`~bigdl_tpu_torch.utils.module_serializer`) beside the ``params``
and ``state`` trees.

Leaves may be numpy arrays or torch tensors (copied to the host);
loaded trees hold numpy arrays. Save and load seconds go into the
``train/checkpoint/save_s`` and ``train/checkpoint/load_s`` histograms
of :data:`bigdl_tpu_torch.telemetry.REGISTRY`.

The ``ckpt/write_manifest`` fault point sits between the staged files
and the MANIFEST (the torn-write window).

Not ported: remote paths (:mod:`~bigdl_tpu_torch.utils.file_io`), the
elastic per-shard format 3 (its MANIFEST raises NotImplementedError),
and ``arm_scripted_crash``, the environment-keyed SIGKILL schedule on
that point (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import re
import shutil
import time
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch import faults, telemetry
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.table import Table

__all__ = ["CheckpointCorrupt", "LOAD_ERRORS", "MANIFEST",
           "find_latest_checkpoint", "list_complete_checkpoints",
           "load_checkpoint", "load_module", "load_module_weights",
           "load_tree", "publish_checkpoint_dir", "quarantine_checkpoint",
           "save_checkpoint", "save_module", "save_tree",
           "verify_checkpoint"]

logger = logging.getLogger(__name__)

_CKPT_SAVE_S = telemetry.histogram(
    "train/checkpoint/save_s", "wall-clock seconds per checkpoint save")
_CKPT_LOAD_S = telemetry.histogram(
    "train/checkpoint/load_s", "wall-clock seconds per checkpoint load")

MANIFEST = "MANIFEST.json"
_CKPT_FILES = ("params", "opt_state", "model_state")


def _host_leaf(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tree_to_template(tree):
    """The tree's structure, JSON-able, with leaf placeholders."""
    if isinstance(tree, Table):
        return {"__table__": {str(k): _tree_to_template(v)
                              for k, v in tree.items()}}
    if isinstance(tree, dict):
        return {k: _tree_to_template(v) for k, v in sorted(tree.items())}
    return "__leaf__"


def _flatten_leaves(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Table):
        for k, v in tree.items():
            out.update(_flatten_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten_leaves(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = _host_leaf(tree)
    return out


def _rebuild(template, arrays, prefix: str = ""):
    if template == "__leaf__":
        return arrays[prefix.rstrip("/")]
    if isinstance(template, dict) and "__table__" in template:
        t = Table()
        for k, v in template["__table__"].items():
            key = int(k) if k.lstrip("-").isdigit() else k
            t[key] = _rebuild(v, arrays, f"{prefix}{k}/")
        return t
    return {k: _rebuild(v, arrays, f"{prefix}{k}/")
            for k, v in template.items()}


def save_tree(path_prefix: str, tree) -> None:
    """Save a tree as ``<prefix>.json`` + ``<prefix>.npz``."""
    with file_io.open_file(path_prefix + ".json", "w") as f:
        json.dump(_tree_to_template(tree), f)
    with file_io.open_file(path_prefix + ".npz", "wb") as f:
        np.savez(f, **_flatten_leaves(tree))


def load_tree(path_prefix: str):
    """A tree saved by :func:`save_tree` (numpy leaves)."""
    with file_io.open_file(path_prefix + ".json") as f:
        template = json.load(f)
    with file_io.open_file(path_prefix + ".npz", "rb") as f:
        with np.load(f) as z:
            arrays = {k: z[k] for k in z.files}
    return _rebuild(template, arrays)


class CheckpointCorrupt(RuntimeError):
    """A checkpoint directory failed verification: a file its MANIFEST
    names is missing or no longer hashes to the recorded sha256. The
    driver's resume quarantines the directory and walks back to the
    previous intact checkpoint."""

    # it escapes a resume only where the quarantine failed: a retry would
    # hash the same directory again, so the retry policy fails fast
    bigdl_fatal = True


#: what reading a damaged checkpoint raises (a digest that does not
#: match, a missing or truncated file, a torn archive or document)
LOAD_ERRORS = (CheckpointCorrupt, OSError, ValueError, KeyError, EOFError,
               zipfile.BadZipFile)


def _fsync(f) -> None:
    try:
        f.flush()
        os.fsync(f.fileno())
    except (OSError, AttributeError):
        pass


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _part_blobs(flats, host):
    """Each checkpoint file as ``(name, bytes, sha256)``, one at a time:
    the digest hashes the exact bytes written, in one pass."""
    def blob(fname, data):
        return fname, data, hashlib.sha256(data).hexdigest()

    for name, (arrays, template) in flats.items():
        yield blob(name + ".json", json.dumps(template).encode())
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        yield blob(name + ".npz", buf.getvalue())
    yield blob("host_state.json", json.dumps(host).encode())


def publish_checkpoint_dir(staged: str, path: str) -> None:
    """Publish a complete staged checkpoint directory: move an existing
    ``path`` aside, rename ``staged`` into place, fsync the parent, and
    only then remove ``<path><prefix>*`` debris. A crash at any point
    leaves the previous or the new complete checkpoint reachable."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    base = os.path.basename(path)
    old = f"{path}.old-{os.getpid()}"
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(staged, path)
    _fsync_dir(parent)
    doomed = (base + ".tmp-", base + ".old-")
    for name in os.listdir(parent):
        if name.startswith(doomed):
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)


def save_checkpoint(path: str, *, params, opt_state, model_state,
                    optim_host_state: Dict[str, Any],
                    driver_state: Dict[str, Any]) -> None:
    """Checkpoint a training run at ``path`` (DistriOptimizer.checkpoint
    :433-463) crash-safely, in format 2: the files are staged in
    ``<path>.tmp-<pid>`` and fsynced, the MANIFEST (each file's sha256)
    is written last, and the directory is renamed into place."""
    t0 = time.perf_counter()
    try:
        flats = {k: (_flatten_leaves(t), _tree_to_template(t))
                 for k, t in (("params", params), ("opt_state", opt_state),
                              ("model_state", model_state))}
        host = {"optim_host_state": optim_host_state,
                "driver_state": driver_state}
        files = [f"{n}.{ext}" for n in _CKPT_FILES
                 for ext in ("json", "npz")] + ["host_state.json"]
        manifest = {"format": 2, "neval": driver_state.get("neval"),
                    "files": files, "sha256": {}}
        path = os.path.abspath(file_io.local_path(path))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        if os.path.exists(tmp):          # our own earlier failed attempt
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for fname, data, digest in _part_blobs(flats, host):
            manifest["sha256"][fname] = digest
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(data)
                _fsync(f)
        # the torn-write window: payload staged, MANIFEST not yet written
        faults.point("ckpt/write_manifest",
                     neval=driver_state.get("neval", -1), path=path)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            _fsync(f)
        _fsync_dir(tmp)
        publish_checkpoint_dir(tmp, path)
    finally:
        _CKPT_SAVE_S.observe(time.perf_counter() - t0)


def verify_checkpoint(path: str) -> None:
    """Check one checkpoint directory against its MANIFEST: every file
    listed present and, from format 2, hashing to its recorded sha256.
    Raises :class:`CheckpointCorrupt` naming the first bad file. A
    directory without a MANIFEST (format 0) or without digests (format
    1) passes on what it records."""
    mpath = file_io.join(path, MANIFEST)
    if not file_io.exists(mpath):
        return
    try:
        with file_io.open_file(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable MANIFEST ({e})")
    digests = manifest.get("sha256") or {}
    for fname in manifest.get("files", []):
        fpath = file_io.join(path, fname)
        if not file_io.exists(fpath):
            raise CheckpointCorrupt(
                f"{path}: MANIFEST names {fname} but it is missing")
        want = digests.get(fname)
        if want is None:
            continue
        got = file_io.file_sha256(fpath)
        if got != want:
            raise CheckpointCorrupt(
                f"{path}: {fname} fails its recorded sha256 "
                f"(got {got[:12]}…, want {want[:12]}…)")


def quarantine_checkpoint(path: str) -> Optional[str]:
    """Move a corrupt checkpoint directory aside to
    ``<path>.corrupt-<pid>``, which :func:`find_latest_checkpoint` never
    selects. Returns the new path, or None when the rename fails."""
    dst = f"{path}.corrupt-{os.getpid()}"
    if file_io.rename(path, dst):
        logger.warning("quarantined corrupt checkpoint %s -> %s", path, dst)
        return dst
    return None


def load_checkpoint(path: str, verify: bool = True) -> Dict[str, Any]:
    """One complete checkpoint directory written by either package's
    ``save_checkpoint``, verified first (``verify=False`` skips the
    hashes): ``{"params", "opt_state", "model_state",
    "optim_host_state", "driver_state"}``. A format-3 (elastic) MANIFEST
    raises NotImplementedError."""
    t0 = time.perf_counter()
    try:
        mpath = file_io.join(path, MANIFEST)
        if file_io.exists(mpath):
            try:
                with file_io.open_file(mpath) as f:
                    fmt = int(json.load(f).get("format", 0))
            except (OSError, ValueError) as e:
                raise CheckpointCorrupt(f"{path}: unreadable MANIFEST ({e})")
            if fmt >= 3:
                raise NotImplementedError(
                    f"{path}: checkpoint format {fmt} (the elastic per-shard "
                    f"layout) is not ported; the port reads formats 0-2")
        if verify:
            verify_checkpoint(path)
        with file_io.open_file(file_io.join(path, "host_state.json")) as f:
            host = json.load(f)
        return {"params": load_tree(file_io.join(path, "params")),
                "opt_state": load_tree(file_io.join(path, "opt_state")),
                "model_state": load_tree(file_io.join(path, "model_state")),
                "optim_host_state": host["optim_host_state"],
                "driver_state": host["driver_state"]}
    finally:
        _CKPT_LOAD_S.observe(time.perf_counter() - t0)


def list_complete_checkpoints(directory: str) -> list:
    """Every complete checkpoint directory under ``directory`` as
    ``[((neval, properly named), path), ...]``, oldest first. Complete
    means a MANIFEST (a complete ``*.tmp-*`` / ``*.old-*`` stray counts),
    or, for a properly named ``checkpoint[.N]`` without one (format 0),
    a ``host_state.json``; ``*.corrupt-*`` quarantines never count."""
    out = []
    if not file_io.isdir(directory):
        return out
    for name in sorted(file_io.listdir(directory)):
        full = file_io.join(directory, name)
        if not name.startswith("checkpoint") or not file_io.isdir(full):
            continue
        if ".corrupt-" in name:
            continue
        if not file_io.exists(file_io.join(full, "host_state.json")):
            continue
        proper = re.match(r"checkpoint(\.\d+)?$", name) is not None
        if file_io.exists(file_io.join(full, MANIFEST)):
            try:
                with file_io.open_file(file_io.join(full, MANIFEST)) as f:
                    neval = json.load(f).get("neval") or 0
            except (OSError, ValueError):
                continue
        elif proper:
            m = re.match(r"checkpoint\.(\d+)$", name)
            neval = int(m.group(1)) if m else 0
        else:
            continue
        out.append(((neval, proper), full))
    out.sort(key=lambda e: e[0])
    return out


def find_latest_checkpoint(directory: str) -> Optional[str]:
    """The newest complete checkpoint directory
    (DistriOptimizer.getLatestFile :867-880), or None."""
    entries = list_complete_checkpoints(directory)
    return entries[-1][1] if entries else None


def save_module(path: str, module) -> None:
    """Save a module's topology, parameters and state to the directory
    ``path``; :func:`load_module` in either package rebuilds it."""
    from bigdl_tpu_torch.utils.module_serializer import to_spec
    file_io.makedirs(path)
    save_tree(file_io.join(path, "params"), module.get_parameters())
    save_tree(file_io.join(path, "state"), module.get_state())
    meta = {"class": type(module).__name__, "name": module.get_name(),
            "spec": to_spec(module), "format_version": 1}
    with file_io.open_file(file_io.join(path, "module.json"), "w") as f:
        json.dump(meta, f)


def load_module(path: str, device=None):
    """Rebuild a module saved by either package's ``save_module``, with
    its weights, on ``device`` (the card by default; ``"cpu"`` to run
    on the CPU)."""
    from bigdl_tpu_torch.utils.engine import resolve_device
    from bigdl_tpu_torch.utils.module_serializer import from_spec
    device = resolve_device(device)
    with file_io.open_file(file_io.join(path, "module.json")) as f:
        meta = json.load(f)
    module = from_spec(meta["spec"])
    return load_module_weights(path, module.to(device))


def load_module_weights(path: str, module):
    """Copy the params and state saved at ``path`` into ``module``."""
    module.set_parameters(load_tree(file_io.join(path, "params")))
    module.set_state(load_tree(file_io.join(path, "state")))
    return module

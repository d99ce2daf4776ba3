"""File IO for checkpoints and saved modules (counterpart of
``bigdl_tpu.utils.file_io``; reference utils/File.scala).

Local paths only, through the standard library. The JAX package sends a
``scheme://`` path (hdfs://, s3://, gs://) through fsspec; the port
raises NotImplementedError for one (``file://`` is local).
"""
from __future__ import annotations

import hashlib
import os
import re
from typing import List

__all__ = ["exists", "file_sha256", "is_remote", "isdir", "join", "listdir",
           "local_path", "makedirs", "open_file", "rename"]

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path: str) -> bool:
    return bool(_SCHEME_RE.match(path)) and not path.startswith("file://")


def local_path(path: str) -> str:
    """``path`` as a local filesystem path; a remote one raises."""
    if is_remote(path):
        raise NotImplementedError(
            f"{path}: remote paths (the JAX package's fsspec transport) are "
            f"not ported; use a local path")
    return path[len("file://"):] if path.startswith("file://") else path


def open_file(path: str, mode: str = "r"):
    return open(local_path(path), mode)


def makedirs(path: str) -> None:
    os.makedirs(local_path(path), exist_ok=True)


def exists(path: str) -> bool:
    return os.path.exists(local_path(path))


def isdir(path: str) -> bool:
    return os.path.isdir(local_path(path))


def listdir(path: str) -> List[str]:
    """Base names of the entries in a directory."""
    return os.listdir(local_path(path))


def join(path: str, *parts: str) -> str:
    return os.path.join(path, *parts)


def rename(src: str, dst: str) -> bool:
    """Rename ``src`` to ``dst``; False when the filesystem refuses (a
    read-only parent, a cross-device link): the caller then handles
    ``src`` still being there."""
    try:
        os.rename(local_path(src), local_path(dst))
        return True
    except OSError:
        return False


def file_sha256(path: str) -> str:
    """Streaming sha256 hex digest of one file (what a MANIFEST
    records and verification recomputes)."""
    h = hashlib.sha256()
    with open_file(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()

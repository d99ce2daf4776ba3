"""Build the port's CUDA kernels with ``nvcc`` and bind them with
``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface, ``_build/lib<name>-<hash>.so``, where the hash
covers the source, every header under ``csrc/``, the flags and the
compiler path — an edit rebuilds, an unchanged tree reuses the
library. Nothing compiles at import: :func:`load` builds at first use,
and :func:`build` compiles several sources at once (one ``nvcc`` per
source, all started together). A failed build raises with nvcc's
stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["NVCC_FLAGS", "build", "build_log", "library_path", "load",
           "nvcc_path"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
#: serializes builds: two threads reaching first use together must not
#: run two nvcc processes onto one temporary file
_build_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    the PATH, else the toolkit's default install."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the "
        "port's CUDA kernels are built from source at first use")


def _digest(name: str, nvcc: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    return BUILD_DIR / f"lib{name}-{_digest(name, nvcc_path())}.so"


def _sources(names: Iterable[str] = None) -> List[str]:
    if names is None:
        return sorted(p.stem for p in CSRC.glob("*.cu"))
    return list(names)


def build(names: Iterable[str] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) whose
    library is missing, in parallel; returns ``{name: library path}``.
    Raises RuntimeError with nvcc's stderr if any build fails."""
    with _build_lock:
        return _build_locked(_sources(names))


def _build_locked(names: List[str]) -> Dict[str, Path]:
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True),
                      tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{err}{out}")
            continue
        os.replace(tmp, path)
        with _lock:
            _logs[name] = err + out
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for a library this process built; empty if it was reused."""
    with _lock:
        return _logs.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(path))
    return lib

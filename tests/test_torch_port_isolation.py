"""The port stands alone: ``bigdl_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``bigdl_tpu``, not
even its JAX-free modules."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "bigdl_tpu")


def _port_files():
    files = sorted((ROOT / "bigdl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_exist():
    files = _port_files()
    assert all(f.is_file() for f in files)
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_reference_module():
    code = ("import sys, bigdl_tpu_torch, bigdl_tpu_torch.generation, "
            "bigdl_tpu_torch.kernels._build, bigdl_tpu_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m == 'bigdl_tpu' "
            "or m.startswith('bigdl_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

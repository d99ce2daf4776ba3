"""The port stands alone: ``bigdl_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``bigdl_tpu``, not
even its JAX-free modules; and importing the port loads no Pillow (the
card's machine has none: only a JPEG or PNG decode imports it)."""
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
            "bigdl_tpu_torch.kernels._build, bigdl_tpu_torch.convert, "
            "bigdl_tpu_torch.kernels.config, "
            "bigdl_tpu_torch.kernels.flash_attention, "
            "bigdl_tpu_torch.optim, bigdl_tpu_torch.dataset, "
            "bigdl_tpu_torch.precision, bigdl_tpu_torch.dataset.prefetch, "
            "bigdl_tpu_torch.datapipe, bigdl_tpu_torch.datapipe.pipeline, "
            "bigdl_tpu_torch.datapipe.readers, "
            "bigdl_tpu_torch.datapipe.shuffle, "
            "bigdl_tpu_torch.datapipe.stage, "
            "bigdl_tpu_torch.dataset.imagenet, "
            "bigdl_tpu_torch.dataset.image, "
            "bigdl_tpu_torch.dataset.seqfile, bigdl_tpu_torch.utils.crc32c, "
            "bigdl_tpu_torch.models.resnet.train, "
            "bigdl_tpu_torch.models.transformer.train, "
            "bigdl_tpu_torch.models.transformer.test, "
            "bigdl_tpu_torch.nn.dropout, bigdl_tpu_torch.nn.moe, "
            "bigdl_tpu_torch.dataset.text, bigdl_tpu_torch.faults, "
            "bigdl_tpu_torch.faults.core, bigdl_tpu_torch.fleet, "
            "bigdl_tpu_torch.fleet.prefix, bigdl_tpu_torch.fleet.replica, "
            "bigdl_tpu_torch.fleet.router, bigdl_tpu_torch.fleet.soak, "
            "bigdl_tpu_torch.fleet.speculative, bigdl_tpu_torch.autotune, "
            "bigdl_tpu_torch.autotune.config, bigdl_tpu_torch.models, "
            "bigdl_tpu_torch.models.vgg.train, "
            "bigdl_tpu_torch.models.vgg.test, "
            "bigdl_tpu_torch.models.inception.train, "
            "bigdl_tpu_torch.models.inception.test, "
            "bigdl_tpu_torch.models.alexnet, "
            "bigdl_tpu_torch.models.autoencoder.train, "
            "bigdl_tpu_torch.models.autoencoder.test, "
            "bigdl_tpu_torch.nn.norm, bigdl_tpu_torch.nn.criterion, "
            "bigdl_tpu_torch.nn.initialization, bigdl_tpu_torch.tools.perf, "
            "bigdl_tpu_torch.nn.recurrent, bigdl_tpu_torch.nn.embedding, "
            "bigdl_tpu_torch.nn.graph, bigdl_tpu_torch.nn.control_ops, "
            "bigdl_tpu_torch.utils.directed_graph, "
            "bigdl_tpu_torch.models.rnn, bigdl_tpu_torch.models.rnn.train, "
            "bigdl_tpu_torch.models.rnn.test, "
            "bigdl_tpu_torch.dataset.device_dataset, "
            "bigdl_tpu_torch.dataset.native_dataset, "
            "bigdl_tpu_torch.dataset.fetch, bigdl_tpu_torch.native, "
            "bigdl_tpu_torch.utils.transfer, "
            "bigdl_tpu_torch.tools.imagenet_seqfile_generator\n"
            "bad = sorted(m for m in sys.modules if m == 'bigdl_tpu' "
            "or m.startswith('bigdl_tpu.'))\n"
            "bad += ['PIL'] if 'PIL' in sys.modules else []\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_sources():
    files = _port_files()
    files += sorted((ROOT / "bigdl_tpu_torch").rglob("*.cpp"))
    return files


def test_no_port_file_names_the_reference_native_library():
    bad = [str(f.relative_to(ROOT)) for f in _port_sources()
           if "bigdl_tpu/native" in f.read_text()
           or "libbigdl_native.so" in f.read_text()]
    assert bad == []


def test_the_port_loads_its_own_native_library():
    """The native library the port loads is built from the port's own
    sources into its own build directory; the JAX package's is never
    opened."""
    code = ("import sys\n"
            "from bigdl_tpu_torch import native\n"
            "from bigdl_tpu_torch.dataset import load_mnist\n"
            "lib = native.load_library()\n"
            "print(lib._name)\n"
            "maps = open('/proc/self/maps').read()\n"
            "sys.exit(1 if 'libbigdl_native.so' in maps else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = Path(proc.stdout.strip().splitlines()[-1])
    build = ROOT / "bigdl_tpu_torch" / "native" / "_build"
    assert path.parent == build and path.name.startswith(
        "libbigdl_torch_native-")

"""Compile the port's CUDA sources with g++ against ``_cuda_emulation.h``
(shared by ``test_torch_flash_emulated.py`` and
``test_torch_int8_emulated.py``).

The only rewrites are mechanical: comments go, the named inline-PTX
helpers' bodies become the emulation's calls, ``kernel<<<...>>>(...)``
an ``emu_launch``, and ``extern __shared__`` a pointer to the block's
buffer. Everything else — index arithmetic, fragment layouts, masking,
edge tiles, the cp.async rings — runs as written.
"""
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "bigdl_tpu_torch" / "kernels" / "csrc"
#: headers the sources include that the emulation header stands in for
CUDA_HEADERS = ("cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h",
                "math_constants.h")


def _replace_body(src: str, signature: str, body: str) -> str:
    start = src.index("{", src.index(signature))
    depth = 0
    for end in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            return src[:start] + "{ " + body + " }" + src[end + 1:]
    raise ValueError(f"unbalanced body of {signature}")


def emulated_source(text: str, emulated: dict) -> str:
    """``text`` with comments dropped, each ``emulated`` helper's body
    (keyed by the start of its signature) replaced, launches and dynamic
    shared memory rewritten."""
    text = re.sub(r"//[^\n]*", "", text)
    for signature, body in emulated.items():
        text = _replace_body(text, signature, body)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", text)
    return re.sub(r"([\w:]+(?:<[\w\s,]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  r"emu_launch(\1, \2, \3);", text, flags=re.S)


def build(out: Path, files: dict, libraries) -> Path:
    """Write ``files`` (``{file name in csrc: emulated helpers}``) into
    ``out`` rewritten, then compile each of ``libraries`` (``.cu``
    stems) into ``out/lib<stem>.so`` with g++, one process each, in
    parallel. Skips the test when g++ is missing."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed: the emulated kernels need it")
    for name, emulated in files.items():
        (out / name).write_text(emulated_source((CSRC / name).read_text(),
                                                emulated))
    for name in CUDA_HEADERS:
        (out / name).write_text("#pragma once\n")

    def compile_one(stem):
        return subprocess.run(
            [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
             "-include", str(HERE / "_cuda_emulation.h"), f"-I{out}",
             "-x", "c++", str(out / f"{stem}.cu"), "-o",
             str(out / f"lib{stem}.so")], capture_output=True, text=True,
            timeout=600)

    with ThreadPoolExecutor(len(libraries)) as pool:
        for proc in pool.map(compile_one, libraries):
            assert proc.returncode == 0, proc.stderr[-4000:]
    return out

"""Build and load the port's CUDA kernels.

``build(source)`` compiles a kernel's ``csrc/<name>.cu`` with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, from the
sources in the package only; ``load(source)`` opens it with ``ctypes``
(once per process).  Both run at first use, never at import: the CPU
tests import every module.  Headers shared by several kernels live in
``kernels/common/csrc`` (``INCLUDE_DIRS``, passed to nvcc with ``-I``).
A library is named by ``source_digest``: a hash of its source, of every
header it includes with ``#include "..."`` (followed recursively) and of
the flags, in ``src/repro_torch/_build`` (listed in ``.gitignore``), so
an edited source or header is never served stale.  The compiler's report
(registers, shared memory, spills) is kept beside the library as
``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
INCLUDE_DIRS = (Path(__file__).resolve().parent / "common" / "csrc",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _includes(source: Path, include_dirs) -> list:
    """``source`` and every file it includes with ``#include "..."``,
    recursively, each once, in the order first met.  A name is looked up
    beside the including file, then in ``include_dirs``, as nvcc does; a
    name found nowhere is left to the compiler to report."""
    seen, order, todo = set(), [], [Path(source).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        order.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            for base in (path.parent, *include_dirs):
                cand = (Path(base) / name).resolve()
                if cand.is_file():
                    todo.append(cand)
                    break
    return order


def source_digest(source: Path, include_dirs=INCLUDE_DIRS,
                  flags=NVCC_FLAGS) -> str:
    """Hash of ``source``, the headers it includes and the flags."""
    h = hashlib.sha256()
    for path in _includes(source, include_dirs):
        data = path.read_bytes()
        h.update(f"{path.name}:{len(data)}:".encode())
        h.update(data)
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA toolkit "
                       "is needed to build the port's kernels")


def build(source: Path) -> Path:
    """Compile ``source`` unless this version is built already.  Raises
    with the compiler's output if ``nvcc`` fails."""
    source = Path(source)
    out = BUILD_DIR / f"lib{source.stem}_{source_digest(source)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    incs = [f"-I{d}" for d in INCLUDE_DIRS]
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *incs, "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} with code "
                           f"{proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The library of ``source``, built first if needed."""
    return ctypes.CDLL(str(build(source)))

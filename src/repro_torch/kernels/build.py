"""Build and load the port's CUDA kernels.

``build(source)`` compiles a kernel's ``csrc/<name>.cu`` with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, from the
sources in the package only; ``load(source)`` opens it with ``ctypes``
(once per process).  Both run at first use, never at import: the CPU
tests import every module.  A library is named by a hash of its source
and the flags, in ``src/repro_torch/_build`` (listed in ``.gitignore``),
so an edited source is never served stale.  The compiler's report
(registers, shared memory, spills) is kept beside the library as
``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
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

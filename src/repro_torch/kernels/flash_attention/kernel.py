"""Build and load the CUDA flash-attention kernel.

``csrc/flash_attention.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, from the
sources in the package only, and loaded with ``ctypes``.  The library is
named by a hash of the source and the flags, in ``src/repro_torch/_build``
(listed in ``.gitignore``), so an edited source is never served stale.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
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
                       "is needed to build the flash-attention kernel")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libflash_attention_{digest}.so"


def build() -> Path:
    """Compile the kernel unless this source is built already.  Raises
    with the compiler's output if ``nvcc`` fails.  The compiler's report
    (registers, shared memory, spills) is kept beside the library as
    ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load():
    """The loaded library, built first if needed (once per process)."""
    import ctypes

    lib = ctypes.CDLL(str(build()))
    fn = lib.flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 4 + [i32] * 7 + [i64] * 12
                   + [i32, i32, ctypes.c_float, i32, ptr])
    fn.restype = i32
    return lib

"""The port's kernel build names a library by its source and headers.

``repro_torch.kernels.build.source_digest`` hashes a kernel's source,
every header it includes with ``#include "..."`` (followed recursively,
beside the including file first, then in the include directories) and
the nvcc flags.  An edited header must give a new digest, so that the
library is rebuilt instead of served stale from ``_build/``; a file the
source does not include must not.  No nvcc is needed: the digest reads
files only.
"""

from pathlib import Path

from repro_torch.kernels import build


def _tree(tmp_path: Path):
    src_dir, inc_dir = tmp_path / "csrc", tmp_path / "common"
    src_dir.mkdir()
    inc_dir.mkdir()
    (inc_dir / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (inc_dir / "inner.cuh").write_text("constexpr int K = 1;\n")
    (src_dir / "local.cuh").write_text("constexpr int L = 2;\n")
    (inc_dir / "unrelated.cuh").write_text("constexpr int U = 3;\n")
    source = src_dir / "kernel.cu"
    source.write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n'
                      '  #  include "local.cuh"\n#include "missing.cuh"\n'
                      "int main() { return K + L; }\n")
    return source, inc_dir


def test_digest_follows_included_headers(tmp_path):
    source, inc_dir = _tree(tmp_path)
    dirs = (inc_dir,)
    base = build.source_digest(source, dirs)
    assert build.source_digest(source, dirs) == base
    # a header included through another header
    (inc_dir / "inner.cuh").write_text("constexpr int K = 7;\n")
    d_inner = build.source_digest(source, dirs)
    assert d_inner != base
    # a header beside the source
    (source.parent / "local.cuh").write_text("constexpr int L = 9;\n")
    d_local = build.source_digest(source, dirs)
    assert d_local not in (base, d_inner)
    # the source itself, and the flags
    source.write_text(source.read_text() + "// edit\n")
    d_src = build.source_digest(source, dirs)
    assert d_src not in (base, d_inner, d_local)
    assert build.source_digest(source, dirs, flags=("-O2",)) != d_src


def test_digest_ignores_files_not_included(tmp_path):
    source, inc_dir = _tree(tmp_path)
    dirs = (inc_dir,)
    base = build.source_digest(source, dirs)
    (inc_dir / "unrelated.cuh").write_text("constexpr int U = 4;\n")
    (source.parent / "notes.txt").write_text("not a header\n")
    assert build.source_digest(source, dirs) == base
    included = [p.name for p in build._includes(source, dirs)]
    assert included == ["kernel.cu", "outer.cuh", "local.cuh", "inner.cuh"]


def test_port_kernels_include_the_shared_header():
    """Both redesigned kernels include the shared Hopper header, so an
    edit of it reaches both libraries' digests."""
    root = Path(build.__file__).resolve().parent
    header = build.INCLUDE_DIRS[0] / "sm90.cuh"
    assert header.is_file()
    for name in ("flash_attention/csrc/flash_attention.cu",
                 "moe_mlp/csrc/moe_mlp.cu"):
        assert header.resolve() in build._includes(root / name,
                                                   build.INCLUDE_DIRS)

"""The port's kernel builder (``repro_torch.kernels._build``): a library is
named by a hash of its source, every local header the source includes
(recursively) and the flags, so an edited header never loads a stale
build.  No nvcc is needed: only the names are computed."""
from pathlib import Path

from repro_torch.kernels import _build


def _tree(root: Path) -> Path:
    (root / "sub").mkdir()
    (root / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                               "int k() { return a(); }\n")
    (root / "a.cuh").write_text('#pragma once\n  #  include "sub/b.cuh"\n'
                                "inline int a() { return b(); }\n")
    (root / "sub" / "b.cuh").write_text("inline int b() { return 1; }\n")
    return root / "k.cu"


def test_local_sources_follow_includes_recursively(tmp_path):
    source = _tree(tmp_path)
    assert _build.local_sources(source) == [
        source, tmp_path / "a.cuh", tmp_path / "sub" / "b.cuh"]


def test_library_path_changes_with_an_included_header(tmp_path):
    source = _tree(tmp_path)
    before = _build.library_path(source)
    assert _build.library_path(source) == before
    (tmp_path / "sub" / "b.cuh").write_text("inline int b() { return 2; }\n")
    after = _build.library_path(source)
    assert after != before and after.parent == before.parent
    assert after.name.startswith("libk-")


def test_port_kernels_hash_the_shared_header():
    for name in ("flash_attention.cu", "moe_gemm.cu"):
        assert _build.CSRC / "hopper.cuh" in _build.local_sources(
            _build.CSRC / name)

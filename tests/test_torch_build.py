"""The port's kernel build names each library by a hash of its source and
of the csrc headers that source includes, so that editing a header
rebuilds every kernel that uses it. Nothing here needs nvcc: the tests
read the names only, in a temporary csrc directory."""

import pytest

from objective_slam_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc directory: a.cu includes h.cuh, which includes g.cuh; b.cu
    includes nothing; other.cuh is included by no one."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include <cstdint>\n#include "h.cuh"\n'
                              "int a;\n")
    (src / "h.cuh").write_text('#pragma once\n  #  include "g.cuh"\n'
                               "int h;\n")
    (src / "g.cuh").write_text("#pragma once\nint g;\n")
    (src / "b.cu").write_text("int b;\n")
    (src / "other.cuh").write_text("int other;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_sources_follow_quoted_includes(csrc):
    assert [p.name for p in _build._sources("a")] == ["a.cu", "h.cuh",
                                                      "g.cuh"]
    assert [p.name for p in _build._sources("b")] == ["b.cu"]


@pytest.mark.parametrize("edited,a_moves,b_moves", [
    ("a.cu", True, False),
    ("h.cuh", True, False),       # a header the kernel includes
    ("g.cuh", True, False),       # included through another header
    ("other.cuh", False, False),  # a header no kernel includes
    ("b.cu", False, True),
])
def test_editing_a_source_or_its_header_changes_the_library(
        csrc, edited, a_moves, b_moves):
    before = _build.library_path("a"), _build.library_path("b")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _build.library_path("a"), _build.library_path("b")
    assert (before[0] != after[0]) == a_moves
    assert (before[1] != after[1]) == b_moves
    assert after[0].parent == csrc.parent / "build"


def test_both_kernels_include_the_row_header():
    """K1 and K2 share csrc/row_hist.cuh (the cluster reduction), so both
    libraries are named by it."""
    for name in ("block_tally", "fast_tally"):
        assert "row_hist.cuh" in [p.name for p in _build._sources(name)]


def test_the_icp_kernel_is_built_with_the_others():
    """The ICP kernel and the KinFu Gauss-Newton kernel are built beside
    K1 and K2."""
    assert _build.KERNELS == ("block_tally", "fast_tally", "icp_refine",
                              "gn_track")


@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_kernel_is_named_by_its_source(name):
    """Each kernel of KERNELS has its source csrc/<name>.cu, and its
    library is named after it."""
    src = _build.CSRC / f"{name}.cu"
    assert src.exists() and _build._sources(name)[0] == src
    assert _build.library_path(name).name.startswith(f"lib{name}-")


@pytest.fixture
def nvcc():
    try:
        return _build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit) to build the kernels")


@pytest.mark.card
@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_kernel_builds_and_loads(nvcc, name, tmp_path, monkeypatch):
    """nvcc compiles csrc/<name>.cu into a fresh build directory, and the
    library loads and exports its launcher osn_<name>."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    _build.build((name,))
    assert _build.library_path(name).exists()
    assert hasattr(_build.load(name), f"osn_{name}")

"""The port's kernel build names each library by a hash of its source and
of the csrc headers that source includes, so that editing a header
rebuilds every kernel that uses it; its launch seam calls a kernel's
launcher and turns the launcher's error codes into exceptions. Nothing
here needs nvcc or a card: the build tests read the names only, in a
temporary csrc directory, and the launch tests call each wrapper on CPU
tensors against a fake library."""

import contextlib
import ctypes
from types import SimpleNamespace

import pytest
import torch

from objective_slam_tpu_torch.ops import _build, block_tally, fast_tally, \
    gn_track, icp, raycast


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
    """The ICP kernel and the KinFu Gauss-Newton and raycast kernels are
    built beside K1 and K2, each launched by its own ops module."""
    assert {name: _build.wrapper(name) for name in _build.KERNELS} == {
        "block_tally": block_tally, "fast_tally": fast_tally,
        "icp_refine": icp, "gn_track": gn_track, "raycast": raycast}


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


# ----------------------------------------------------------- the launch seam

def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _k1_call():
    block_tally.block_tally(_i32(2, 128), _i32(4), _i32(4), _i32(1), _i32(),
                            3, 30, cluster=2)


def _k2_call():
    tables = SimpleNamespace(pair_packed=_i32(4), pair_mr=None,
                             pair_alpha=None)
    fast_tally.fast_tally(_i32(2), _i32(2), _i32(2), _i32(1), _i32(1),
                          tables, 2, 64, 3, 30, cluster=1)


def _icp_call():
    icp.refine_pose_kernel(torch.zeros(5, 3), torch.zeros(7, 3),
                           torch.eye(4), max_dist=0.1)


def _gn_call():
    v = torch.zeros(2, 3, 3)
    ok = torch.ones(6, dtype=torch.bool)
    gn_track.gauss_newton(v, v.clone(), ok, torch.zeros(6, 3),
                          torch.zeros(6, 3), ok.clone(), torch.eye(4),
                          torch.eye(4), (1.0, 1.0, 1.0, 1.0), 0.01, 0.5, 10,
                          5)


def _raycast_call():
    vol = torch.zeros(2, 3, 40)
    raycast.raycast_depth(vol, vol.clone(), torch.zeros(3), torch.eye(4),
                          torch.linspace(0.1, 1.0, 8), torch.zeros(4),
                          torch.zeros(5), torch.zeros(6), 20.0, 0.15, 3)


# Each kernel's wrapper call, and the message it raises when no block or
# cluster fits the card.
LAUNCHES = {
    "block_tally": (_k1_call, "block_tally: no cluster of 2 blocks with "
                    "384 B of shared memory each fits the card"),
    "fast_tally": (_k2_call, "fast_tally: no cluster of 1 blocks with 384 B "
                   "of shared memory each fits the card"),
    "icp_refine": (_icp_call, "icp_refine: no block fits an SM"),
    "gn_track": (_gn_call, "gn_track: no block fits an SM"),
    "raycast": (_raycast_call, "raycast: no block fits an SM"),
}


class _FakeLibrary:
    """A loaded kernel library: its launcher osn_<name> records each call
    and returns `code`; osn_cuda_error_string names the code."""

    def __init__(self, name, code):
        def launcher(*args):
            launcher.calls.append(args)
            return code

        def error_string(err):
            return f"fake CUDA error {err}".encode()

        launcher.calls = []
        setattr(self, f"osn_{name}", launcher)
        self.osn_cuda_error_string = error_string


@pytest.mark.parametrize("code", [0, -1, 700], ids=["ok", "no_fit", "error"])
@pytest.mark.parametrize("name", list(_build.KERNELS))
def test_launch_seam(monkeypatch, name, code):
    """Each wrapper launches through _build.launch on the current stream:
    a return of 0 counts one launch, -1 raises the wrapper's own no-fit
    message, any other code the library's error text; neither counts."""
    lib = _FakeLibrary(name, code)
    monkeypatch.setattr(_build, "load",
                        lambda n: lib if n == name else pytest.fail(n))
    monkeypatch.setattr(_build, "uses_kernel", lambda device: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=1234))
    call, no_fit = LAUNCHES[name]
    wrapper = _build.wrapper(name)
    before = wrapper.launches
    launcher = getattr(lib, f"osn_{name}")
    if code == 0:
        call()
        assert wrapper.launches == before + 1
        (args,) = launcher.calls
        assert args[-1] == 1234
        assert len(launcher.argtypes) == len(args)
        assert launcher.argtypes[-1] is ctypes.c_void_p
        assert launcher.restype is ctypes.c_int
        return
    want = no_fit if code == -1 else f"{name}: launch failed: fake CUDA " \
        f"error {code}"
    with pytest.raises(RuntimeError) as err:
        call()
    assert str(err.value) == want
    assert len(launcher.calls) == 1 and wrapper.launches == before

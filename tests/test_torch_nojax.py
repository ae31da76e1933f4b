"""The port must run where JAX is absent (the GPU machine has none):
importing it loads neither jax nor the JAX package, and no module of it,
chip_smoke.py, its tools (tools/*_torch.py) or the card's test files
(tests/test_torch_icp_kernel.py, tests/test_torch_gn_kernel.py,
tests/test_torch_raycast_kernel.py) and the recognition cell's benchmark
files (its kind, its surface reference, its control script) names either
(or bench.py) in an import."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "objective_slam_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "objective_slam_tpu", "bench")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import objective_slam_tpu_torch\n"
        "from objective_slam_tpu_torch.models import drost\n"
        "from objective_slam_tpu_torch.utils import ply, serialization, "
        "synthetic\n"
        "from objective_slam_tpu_torch import cli, pipeline\n"
        "from objective_slam_tpu_torch.ops import fast_tally, voting_fast, "
        "hashing, verify_pose, voting_corr\n"
        "from objective_slam_tpu_torch.utils import debug_dump, html_viewer, "
        "pointcloud, profiling\n"
        "from objective_slam_tpu_torch import io_native\n"
        "from objective_slam_tpu_torch.models import tsdf\n"
        "from objective_slam_tpu_torch.parallel import sharded_match\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tools')\n"
        "import run_uwa_analog_torch\n"
        "import tsdf_smoke_torch\n"
        "import eval_instances_torch, eval_recognition_torch, "
        "ppf_timer_torch, raycast_gap_study_torch, voxel_grid_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py",
                          ROOT / "tests" / "test_torch_icp_kernel.py",
                          ROOT / "tests" / "test_torch_gn_kernel.py",
                          ROOT / "tests" / "test_torch_raycast_kernel.py",
                          ROOT / "benchmark" / "frozen" /
                          "surface_reference.py",
                          ROOT / "benchmark" / "kinds" / "kinfu_recognize.py",
                          ROOT / "benchmark" / "slampp_control.py"] +
                         sorted((ROOT / "tools").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"

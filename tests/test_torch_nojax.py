"""The port must run where JAX is absent (the GPU machine has none):
importing it loads neither jax nor the JAX package, and no module of it,
chip_smoke.py, bench_torch.py, tools/run_uwa_analog_torch.py or
tools/tsdf_smoke_torch.py names either (or bench.py) in an import."""

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
        "import chip_smoke\n"
        "import bench_torch\n"
        "sys.path.insert(0, 'tools')\n"
        "import run_uwa_analog_torch\n"
        "import tsdf_smoke_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
                          ROOT / "tools" / "run_uwa_analog_torch.py",
                          ROOT / "tools" / "tsdf_smoke_torch.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"

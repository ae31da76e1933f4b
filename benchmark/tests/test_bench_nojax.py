"""Nothing the benchmark reaches loads JAX or the JAX package, and the
plain reference imports nothing of the program."""

import ast
import subprocess
import sys
import textwrap

from conftest import REPO

from benchmark import harness

# A run of a cell at toy size on the CPU through run.py's harness, then the
# top-level names of every module it loaded.
_SCRIPT = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(1)
    from benchmark import harness
    from conftest import toy
    manifest = harness.load_json(harness.REPO / "BENCHMARK.json")
    for name in {cells!r}:
        cell = toy(harness.find_cell(manifest, name))
        harness.run_cell(cell, 5, 0.5, True, "cpu", time.perf_counter())
    print(sorted({{m.split(".")[0] for m in sys.modules}}))
""")


def test_no_jax_in_a_run(manifest):
    cells = ["binpick-serve"]
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(
            repo=str(REPO), tests=str(REPO / "benchmark" / "tests"),
            cells=cells)],
        capture_output=True, text=True, timeout=600, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "objective_slam_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES), loaded


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_frozen_code_imports_nothing_of_the_program():
    for path in (REPO / "benchmark" / "frozen").glob("*.py"):
        assert _imports(path) <= {"__future__", "dataclasses", "math",
                                  "typing", "numpy", "torch"}, path


def test_no_file_of_the_benchmark_imports_jax():
    for path in (REPO / "benchmark").rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN_MODULES), path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "objective_slam_tpu_torch_x", sys)
    assert "objective_slam_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "objective_slam_tpu.ops", sys)
    assert "objective_slam_tpu" in harness.forbidden_loaded()

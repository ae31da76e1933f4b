"""BENCHMARK.json and the files it names."""

import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
PER_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51


def test_names_and_units(manifest):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    metric_names = [m["name"] for s in ("end_to_end", "per_layer")
                    for m in manifest[s]]
    assert len(set(metric_names)) == len(metric_names)


def test_metrics(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == PER_LAYER_KEYS
        assert m["moves"] in e2e
        assert m["layer"] and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_cells_resolve(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    used = set()
    for w in manifest["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        assert len(w["why"]) <= 200
        cell = harness.find_cell(manifest, w["name"])
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert (harness.HERE / "loops"
                / f"{cell.traffic['loop']}.py").exists()
        assert cell.per_layer and any(
            m["name"] != "setup_s" for m in cell.end_to_end)
    assert used == configs
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert harness.load_json(harness.REPO / c["file"])["reduced"] \
            == c["reduced"]

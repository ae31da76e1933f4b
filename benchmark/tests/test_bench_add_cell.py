"""A cell is added by data alone: in a copy of the benchmark, a new
configuration file, traffic file and manifest entry are found by name and
run through the harness, and no file that was there changes."""

import hashlib
import json
import shutil
import time

from conftest import REPO, toy

from benchmark import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_from_data_files(tmp_path, manifest):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    cfg = json.loads((tmp_path / "benchmark/configs/binpick-blob100k.json")
                     .read_text())
    cfg["name"] = "binpick-blob50k"
    cfg["scenes"]["n_total"] = 50_000
    cfg["scenes"]["n_inst_pts"] = 7_500
    (tmp_path / "benchmark/configs/binpick-blob50k.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark/traffic/oneshot3.json").write_text(json.dumps(
        {"loop": "closed", "pool": 3, "state": "none"}))
    manifest["configs"].append({
        "name": "binpick-blob50k", "source": "bench.py:224-305",
        "file": "benchmark/configs/binpick-blob50k.json", "reduced": [],
        "why": "half-size scans"})
    manifest["workloads"].append({
        "name": "binpick50k-oneshot", "config": "binpick-blob50k",
        "traffic": "oneshot3", "chips": 1, "why": "half-size scans, no state"})
    for m in manifest["per_layer"]:
        if "workloads" in m and "binpick-oneshot" in m["workloads"]:
            m["workloads"].append("binpick50k-oneshot")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.find_cell(manifest, "binpick50k-oneshot",
                             root=tmp_path / "benchmark")
    assert cell.config["name"] == "binpick-blob50k"
    assert cell.traffic["pool"] == 3 and cell.traffic["state"] == "none"
    cell = toy(cell)
    line, checks = harness.run_cell(cell, 9, 0.5, False, "cpu",
                                    time.perf_counter())
    assert set(line["metrics"]) == {m["name"] for m in manifest[
        "end_to_end"]} - {"peak_mem_gib"}   # no card: no peak to read
    assert line["metrics"]["poses_per_s"]["value"] > 0
    assert line["correct"], checks
    line, _ = harness.run_cell(cell, 9, 0.5, True, "cpu",
                               time.perf_counter())
    assert "drost.ladder_steps" in line["metrics"]
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before

"""The `kinfu_recognize` cell on the CPU at a toy size: it is found from
its data files and runs through the harness traced and untraced and reads
`correct`; its new metrics are numbers and read nothing from a program
without the recognizer's spans and counters; planted faults and the TF32
control read `correct` false; its objects are the scene's meshes."""

import contextlib
import copy
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from benchmark import harness, tracing
from benchmark.frozen import reference as ref
from benchmark.kinds import kinfu_recognize as kind
from benchmark.kinds import ppf_scan
from benchmark.metrics import program_spans, surface_work
from objective_slam_tpu_torch.models import tsdf
from objective_slam_tpu_torch.ops import icp
from objective_slam_tpu_torch.utils import profiling

CELL = "slampp-recognize-512"
NEW = ("kinfu.recognize_ms_per_pose", "kinfu.extract_ms_per_pose",
       "kinfu.extract_roofline", "kinfu.recognize_idle_pct")


def toy(cell):
    """The cell at a size the CPU runs in seconds: a 128³ volume over the
    3 m cube (τ 0.1 m; about 10⁴ surface rows, so extraction takes the
    cell's moment-grid branch), `test_bench_kinfu`'s 80×60 image, a 6-frame
    segment (recognitions on frames 2 and 5), 3 judged requests, and
    coarse objects: 3,000 samples each, d_dist 0.3 of the diameter (about
    7 cm, over 1.5 voxels, so each scene is downsampled)."""
    cfg = copy.deepcopy(cell.config)
    n, w, h = 128, 80, 60
    cfg["volume"].update(dims=n, truncation_m=0.1)
    s = w / cfg["camera"]["width"]
    fx, fy = cfg["camera"]["intrinsics"][:2]
    cfg["camera"].update(intrinsics=[fx * s, fy * s, (w - 1) / 2,
                                     (h - 1) / 2], width=w, height=h)
    cfg["objects"].update(n_raw=3000, tau_d=0.3)
    cfg["judge"]["sample"] = 3
    return cell._replace(config=cfg, traffic=dict(cell.traffic, segment=6))


@pytest.fixture
def cell(manifest):
    return toy(harness.find_cell(manifest, CELL))


def _run(cell, trace=False, seconds=3.0, seed=3):
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter())


def test_cell_is_found_from_data_files_and_is_correct(manifest, cell):
    full = harness.find_cell(manifest, CELL)
    assert full.config["kind"] == "kinfu_recognize"
    assert full.traffic["recognize_every"] == 3
    assert {m["name"] for m in full.per_layer} >= set(NEW)
    line, checks = _run(cell)
    assert line["correct"], checks
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"poses_per_s", "pose_ms_p95",
                                    "setup_s"}     # no card: no peak
    assert set(checks) == set(full.config["limits"]) | {
        "failed_requests", "judged_requests_missing"}


def test_traced_run_reads_the_span_metrics(cell):
    """On the CPU the trace holds no device work: the two device shares
    read nothing (`test_shares_by_hand` reads them)."""
    line, checks = _run(cell, trace=True)
    assert line["correct"], checks
    for name in NEW[:2]:
        value = line["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value), name
        assert value > 0, name
    assert not set(NEW[2:]) & set(line["metrics"])


def test_a_program_without_the_counters_and_spans(cell, monkeypatch):
    """The recognizer as it was before it kept counters and spans: the
    cell still runs and is correct (the harness extracts the surface
    again outside the latency), and the new metrics read nothing."""
    real = tsdf.StreamingRecognizer.recognize

    def recognize(self, names=None):
        out = real(self, names)
        del self.last_recognition
        return out

    real_span = profiling.span

    def span(name):
        if name in ("tsdf.recognize", "tsdf.extract"):
            return contextlib.nullcontext()
        return real_span(name)

    monkeypatch.setattr(tsdf.StreamingRecognizer, "recognize", recognize)
    monkeypatch.setattr(profiling, "span", span)
    line, checks = _run(cell, trace=True)
    assert line["correct"], checks
    assert not set(NEW) & set(line["metrics"])


class _Event:
    def __init__(self, name, start, end, cuda=False, annotation=False):
        self.v = (name, start, end, cuda, annotation)

    def is_user_annotation(self):
        return self.v[4]

    def name(self):
        return self.v[0]

    def start_ns(self):
        return self.v[1]

    def end_ns(self):
        return self.v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.v[3]
                else torch.autograd.DeviceType.CPU)

    def start_thread_id(self):
        return 1


def test_shares_by_hand(monkeypatch):
    """Two requests, the second a recognition: a `tsdf.recognize` span
    [2000, 3000] holding `tsdf.extract` [2000, 2400]; device work 300 ns
    inside the extract span, 200 more inside the recognize span, and 400
    in the first request, which counts for neither."""
    trace = tracing.TraceSummary([
        _Event("benchmark.request.0", 0, 1000, annotation=True),
        _Event("benchmark.request.1", 2000, 3000, annotation=True),
        _Event("k", 100, 500, cuda=True),
        _Event("k", 2050, 2350, cuda=True),
        _Event("k", 2600, 2800, cuda=True)], 1e-6)
    log = [profiling.Span("tsdf.track", 10, 990, -1),
           profiling.Span("tsdf.recognize", 2000, 3000, -1),
           profiling.Span("tsdf.extract", 2000, 2400, 1)]
    monkeypatch.setattr(program_spans, "_program_log", lambda: log)
    reqs = [kind.Request(0, 0, False), kind.Request(2, 0, True)]
    outs = [kind.Outcome(np.eye(4), False, None, None, None, None, None,
                         10 ** 6),
            kind.Outcome(np.eye(4), False, (), None, 4096, 4000, {}, 10 ** 6)]
    recs = [harness.Record(n, r, o, 1e-6)
            for n, (r, o) in enumerate(zip(reqs, outs))]
    run = harness.RunView(recs, 1e-6, 0.0, 0, trace, None)
    need = (8 * 10 ** 6 + 25 * 4096) / 3.35e12
    assert surface_work.extract_roofline_pct(run) == pytest.approx(
        100 * need / 300e-9)
    assert surface_work.idle_pct(run, "tsdf.recognize") == pytest.approx(
        100 * (1 - 500 / 1000))
    assert harness.load_reader("kinfu.recognize_ms_per_pose").read(run) \
        == pytest.approx(1000 / 1e6 / 2)
    assert harness.load_reader("kinfu.extract_ms_per_pose").read(run) \
        == pytest.approx(400 / 1e6 / 2)


def _drop_one_voxel(monkeypatch):
    """Extraction blind to one near-surface voxel: the one in the middle of
    the near set, read as unobserved."""
    real = tsdf.extract_surface

    def extract_surface(volume, capacity=4096, **kw):
        near = torch.nonzero(tsdf._near_surface(volume, 0.5).reshape(-1))
        i = int(near[near.shape[0] // 2])
        w = volume.weight.clone().reshape(-1)
        w[i] = 0.0
        return real(dataclasses.replace(volume, weight=w.reshape(
            volume.weight.shape)), capacity, **kw)

    monkeypatch.setattr(tsdf, "extract_surface", extract_surface)


def _normals_in_bfloat16(monkeypatch):
    """The normal estimators fed the rows in bfloat16."""
    pc = tsdf.pc

    class _PC:
        def __getattr__(self, name):
            return getattr(pc, name)

        @staticmethod
        def _bf16(points):
            return points.to(torch.bfloat16).to(torch.float32)

        def estimate_normals_knn(self, points, **kw):
            return pc.estimate_normals_knn(self._bf16(points), **kw)

        def estimate_normals_grid(self, points, radius, **kw):
            return pc.estimate_normals_grid(self._bf16(points), radius, **kw)

    monkeypatch.setattr(tsdf, "pc", _PC())


def _icp_in_tf32(monkeypatch):
    """ICP as its plain loop (the kernel's twin) with its matrix products'
    operands rounded to TF32."""
    real_refine = icp.refine_pose_plain
    real_mm = torch.Tensor.__matmul__
    inside = []

    def matmul(a, b):
        if inside and a.dtype == torch.float32 and b.dtype == torch.float32:
            a, b = ref.tf32_round(a), ref.tf32_round(b)
        return real_mm(a, b)

    def refine_pose(*a, **kw):
        inside.append(True)
        try:
            return real_refine(*a, **kw)
        finally:
            inside.pop()

    monkeypatch.setattr(torch.Tensor, "__matmul__", matmul)
    monkeypatch.setattr(icp, "refine_pose", refine_pose)


def _judged(cell, device="cpu", sample=None):
    """The harness's judge on one whole segment, served after the warm-up
    as the window serves it: `sample` requests and the slowest judged
    (every request by default)."""
    n = cell.traffic["segment"]
    cell = cell._replace(config=dict(cell.config, judge=dict(
        cell.config["judge"], sample=sample or n)))
    inputs = kind.Inputs(cell.config, cell.traffic, 0)
    dep = kind.Deployment(inputs, device)
    dep.warm_up()
    reqs = inputs.requests()
    records = [harness.Record(i, r, dep.retain(dep.serve(r)), 1e-3)
               for i, r in zip(range(n), reqs)]
    del dep
    if device != "cpu":
        torch.cuda.empty_cache()
    checks = harness.check(kind, kind.Reference(inputs, device), records, 0,
                           cell, 0)
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


FAULTS = pytest.mark.parametrize("fault", [
    _drop_one_voxel, _normals_in_bfloat16, _icp_in_tf32],
    ids=["one-voxel-dropped", "normals-in-bfloat16", "icp-in-tf32"])


@FAULTS
def test_planted_fault_is_refused(cell, monkeypatch, fault):
    fault(monkeypatch)
    correct, checks = _judged(cell)
    assert not correct, checks


@pytest.mark.card
@FAULTS
def test_planted_fault_is_refused_on_the_card(card, manifest, monkeypatch,
                                              fault):
    """The same faults at the cell's full size, on the card: one segment
    after the warm-up, 4 requests and the slowest judged."""
    fault(monkeypatch)
    correct, checks = _judged(harness.find_cell(manifest, CELL), card, 4)
    print(f"{fault.__name__}: {checks}")
    assert not correct, checks


def test_the_tf32_control_is_refused(cell):
    """The plain PPF with its products in TF32, its own answers in the
    program's place on the program's surface, reads over a limit; the
    float32 reference with ICP's start nudged by 1e-6 of the diameter
    reads under every limit."""
    inputs = kind.Inputs(cell.config, cell.traffic, 0)
    dep = kind.Deployment(inputs, "cpu")
    reqs = inputs.requests()
    out = None
    while out is None or out.matches is None:
        out = dep.retain(dep.serve(next(reqs)))
    params, limits = cell.config["judge"], cell.config["limits"]
    fp32 = kind._Matches(inputs, "cpu", ref.FP32)
    low = kind._Matches(inputs, "cpu", ref.Precision(tf32=True))
    s, s_low = fp32.add(out.surface), low.add(out.surface)
    for side, refused in (("control", True), ("nudge", False)):
        rows = [ppf_scan.judge(fp32, kind._Pick(s, i), (
            low.outcome(s_low, i) if side == "control"
            else fp32.outcome(s, i, nudge=1e-6)), params)
            for i in range(len(inputs.models))]
        numbers = ppf_scan.aggregate(rows)
        over = [k for k in ("topk_gap", "survivors_gap", "winner_gap",
                            "pose_gap") if numbers[k] > limits[k]]
        assert bool(over) == refused, (side, numbers)


def test_the_objects_are_the_scene_meshes(cell):
    inputs = kind.Inputs(cell.config, cell.traffic, 0)
    meshes = kind.object_meshes(cell.config)
    assert len(meshes) == len(inputs.models) == 4
    for m, tris in zip(inputs.models, meshes):
        p, n = m["points"], m["normals"]
        assert p.shape == (cell.config["objects"]["n_raw"], 3)
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0,
                                   atol=1e-5)
        # Outward: the normals point away from the object's centre.
        c = tris.reshape(-1, 3).mean(0)
        assert np.mean(np.sum(n * (p - c), axis=1) > 0) > 0.99
        # Resting on the table (z = 0), in the world frame.
        assert abs(p[:, 2].min()) < 0.01
    again = kind.Inputs(cell.config, cell.traffic, 99)
    for a, b in zip(inputs.models, again.models):
        np.testing.assert_array_equal(a["points"], b["points"])
    reqs = inputs.requests()
    marks = [next(reqs).recognize for _ in range(12)]
    assert marks == [False, False, True, False, False, True] * 2

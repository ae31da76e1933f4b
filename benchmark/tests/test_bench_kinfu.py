"""The `kinfu_track` cell on the CPU at a toy size: it runs through the
harness traced and untraced and reads `correct`, its new metrics are
numbers, its control and planted faults read `correct` false, and its
scene holds what the generator promises."""

import copy
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.frozen import kinfu_reference as kr
from benchmark.frozen import reference as ref
from benchmark.generators import kinfu_orbit
from benchmark.kinds import kinfu_track
from objective_slam_tpu_torch.models import tsdf

CELL = "kinfu-track-512"
NEW = ("kinfu.track_ms_per_pose", "kinfu.integrate_ms_per_pose",
       "kinfu.integrate_roofline")


def toy(cell):
    """The cell at a size the CPU runs in seconds: a 64³ volume with a
    truncation of 0.1 m (2.1 voxels; like the cell's 0.03 m, a value
    bfloat16 does not hold), an 80×60 image (the intrinsics scaled with
    it), a 5-frame segment, 3 judged requests."""
    cfg = copy.deepcopy(cell.config)
    n, w, h = 64, 80, 60
    cfg["volume"].update(dims=n, truncation_m=0.1)
    s = w / cfg["camera"]["width"]
    fx, fy = cfg["camera"]["intrinsics"][:2]
    cfg["camera"].update(intrinsics=[fx * s, fy * s, (w - 1) / 2,
                                     (h - 1) / 2], width=w, height=h)
    cfg["judge"]["sample"] = 3
    traffic = dict(cell.traffic, segment=5)
    return cell._replace(config=cfg, traffic=traffic)


@pytest.fixture
def cell(manifest):
    return toy(harness.find_cell(manifest, CELL))


def _run(cell, trace=False, seconds=0.5, seed=3):
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter())


def test_cell_runs_and_is_correct(cell):
    line, checks = _run(cell)
    assert line["correct"], checks
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"poses_per_s", "pose_ms_p95",
                                    "setup_s"}     # no card: no peak
    assert set(checks) == {"pose_gap", "tsdf_gap", "weight_gap",
                           "failed_requests", "judged_requests_missing"}


def test_traced_run_reads_the_span_metrics(cell):
    """On the CPU the trace holds no device work, so the roofline share
    has nothing to read (`test_roofline_by_hand` reads it)."""
    line, checks = _run(cell, trace=True, seconds=1.0)
    assert line["correct"], checks
    for name in NEW[:2]:
        value = line["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value), name
        assert value > 0, name
    assert NEW[2] not in line["metrics"]


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


def test_roofline_by_hand(monkeypatch):
    """Two requests, each a `tsdf.track` then a `tsdf.integrate` span;
    device work inside the integrate spans for 400 and 600 ns (one
    kernel of request 1 half outside its span), and 300 ns inside a
    track span, which does not count."""
    from benchmark import tracing
    from benchmark.metrics import kinfu_work, program_spans
    from objective_slam_tpu_torch.utils import profiling
    trace = tracing.TraceSummary([
        _Event("benchmark.request.0", 0, 1000, annotation=True),
        _Event("benchmark.request.1", 2000, 3000, annotation=True),
        _Event("k", 100, 400, cuda=True),
        _Event("k", 500, 900, cuda=True),
        _Event("k", 2500, 2900, cuda=True),
        _Event("k", 2950, 3100, cuda=True)], 1e-6)
    log = [profiling.Span("tsdf.track", 10, 450, -1),
           profiling.Span("tsdf.integrate", 450, 990, -1),
           profiling.Span("tsdf.track", 2010, 2400, -1),
           profiling.Span("tsdf.integrate", 2400, 3000, -1)]
    monkeypatch.setattr(program_spans, "_program_log", lambda: log)
    reqs = [kinfu_track.Request(f, 0) for f in (3, 4)]
    recs = [harness.Record(n, r, None, 1e-6) for n, r in enumerate(reqs)]
    work = {3: kinfu_work.Work(10 ** 6, 4800),
            4: kinfu_work.Work(2 * 10 ** 6, 4800)}
    run = harness.RunView(recs, 1e-6, 0.0, 0, trace,
                          lambda scan, model: work[scan])
    need = sum(16 * w.updated_voxels + 4 * 4800 for w in work.values()) \
        / 3.35e12
    assert kinfu_work.integrate_roofline_pct(run) == pytest.approx(
        100 * need / ((400 + 450) * 1e-9))
    assert harness.load_reader("kinfu.track_ms_per_pose").read(run) \
        == pytest.approx((440 + 390) / 1e6 / 2)


def _gauss_newton_in_tf32(monkeypatch):
    """The Gauss-Newton steps' products (the frame's points and normals
    moved by the estimate and projected into the model view) with their
    operands rounded to TF32, as a TF32 matrix product rounds them."""
    steps = []

    class _Span:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            steps.append(self.name == "tsdf.gauss_newton")

        def __exit__(self, *exc):
            steps.pop()

    real = tsdf._rotate

    def rotate(R, x, y, z, t=None):
        if steps and steps[-1]:
            R, x, y, z = (ref.tf32_round(v) for v in (R, x, y, z))
        return real(R, x, y, z, t)

    monkeypatch.setattr(tsdf, "profiling",
                        type("profiling", (), {"span": _Span}))
    monkeypatch.setattr(tsdf, "_rotate", rotate)


def _bf16_tsdf(monkeypatch):
    """The tsdf stored in bfloat16 after every update."""
    real = tsdf.integrate_depth

    def integrate_depth(*a, **kw):
        vol = real(*a, **kw)
        return dataclasses.replace(vol, tsdf=vol.tsdf.to(torch.bfloat16)
                                   .to(torch.float32))

    monkeypatch.setattr(tsdf, "integrate_depth", integrate_depth)


def _first_frame_not_fused(monkeypatch):
    """Each segment's first frame tracked and not fused."""
    real = tsdf.StreamingRecognizer.track_depth_frame

    def track_depth_frame(self, depth, intrinsics, T_cw_hint=None, **kw):
        if T_cw_hint is None:
            return real(self, depth, intrinsics, T_cw_hint, **kw)
        self.integrate_depth_frame = lambda *a, **k: None
        try:
            return real(self, depth, intrinsics, T_cw_hint, **kw)
        finally:
            del self.integrate_depth_frame

    monkeypatch.setattr(tsdf.StreamingRecognizer, "track_depth_frame",
                        track_depth_frame)


def _tracking_returns_its_start(monkeypatch):
    def track_frame(volume, depth, intrinsics, T_cw_init, iters=10, **kw):
        n = torch.tensor(10 ** 6, dtype=torch.int32)
        return tsdf.TrackResult(T_cw=torch.as_tensor(T_cw_init), inliers=n,
                                rms=torch.zeros(()), overlap=n)

    monkeypatch.setattr(tsdf, "track_frame", track_frame)


def _march_past_the_band(monkeypatch):
    """The model view raycast with a step of twice the truncation."""
    real = tsdf.raycast_depth

    def raycast_depth(volume, intrinsics, T_wc, shape, t_near=0.1,
                      t_far=6.0, n_steps=192, **kw):
        n = int((t_far - t_near) / (2.0 * volume.truncation)) + 1
        return real(volume, intrinsics, T_wc, shape, t_near, t_far, n, **kw)

    monkeypatch.setattr(tsdf, "raycast_depth", raycast_depth)


def _judged(cell):
    """The harness's judge on one whole segment of 12 frames, served after
    the warm-up as the window serves it, every request judged: the same
    numbers in every run (a timed window ends on any frame)."""
    cell = cell._replace(config=dict(cell.config, judge={"sample": 12}),
                         traffic=dict(cell.traffic, segment=12))
    inputs = kinfu_track.Inputs(cell.config, cell.traffic, 0)
    dep = kinfu_track.Deployment(inputs, "cpu")
    dep.warm_up()
    reqs = inputs.requests()
    records = [harness.Record(n, r, dep.retain(dep.serve(r)), 1e-3)
               for n, r in zip(range(12), reqs)]
    del dep
    checks = harness.check(kinfu_track, kinfu_track.Reference(inputs, "cpu"),
                           records, 0, cell, 0)
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_a_whole_segment_is_correct(cell):
    correct, checks = _judged(cell)
    assert correct, checks


@pytest.mark.parametrize("fault", [
    _gauss_newton_in_tf32, _bf16_tsdf, _first_frame_not_fused,
    _tracking_returns_its_start, _march_past_the_band],
    ids=["gauss-newton-in-tf32", "tsdf-in-bfloat16", "one-frame-not-fused",
         "tracking-returns-its-start", "march-step-over-truncation"])
def test_planted_fault_is_refused(cell, monkeypatch, fault):
    fault(monkeypatch)
    correct, checks = _judged(cell)
    assert not correct, checks


def test_the_tf32_control_is_refused(cell):
    """The reference one precision step lower, in the program's place over
    a 12-frame segment, reads over a limit; the reference with its start
    nudged by 1e-6 of a voxel reads under every limit."""
    traffic = dict(cell.traffic, segment=12)
    inputs = kinfu_track.Inputs(cell.config, traffic, 0)
    fp32 = kinfu_track.replay(inputs, "cpu", keep=11)
    limits = cell.config["limits"]
    for prec, nudge, refused in ((kr.Precision(tf32=True), 0.0, True),
                                 (kr.FP32, 1e-6, False)):
        stream = kinfu_track.session(inputs, "cpu", prec)
        gaps = {"pose_gap": 0.0}
        for f in range(12):
            kinfu_track.advance(stream, inputs, f, nudge)
            gaps["pose_gap"] = max(gaps["pose_gap"], kr.corner_gap(
                stream.T_cw, fp32.poses[f], inputs.origin, inputs.extent))
        gaps.update(kinfu_track.volume_gaps(stream.vol, fp32.volume,
                                            inputs.truncation, 12))
        over = [k for k in limits if gaps[k] > limits[k]]
        assert bool(over) == refused, (prec, nudge, gaps)


def test_a_march_over_the_truncation_is_refused_at_set_up(cell):
    cfg = copy.deepcopy(cell.config)
    cfg["march"]["n_steps"] = 2
    with pytest.raises(ValueError, match="raycast step"):
        kinfu_track.Inputs(cfg, cell.traffic, 0)


def test_the_frames_hold_what_the_generator_promises(cell):
    inputs = kinfu_track.Inputs(cell.config, cell.traffic, 0)
    frames = inputs.posed + inputs.frames
    assert len(inputs.posed) == cell.traffic["posed_frames"]
    for fr in frames:
        assert fr.depth.shape == inputs.shape and fr.pinholes <= 0.01
        seen = fr.depth[fr.depth > 0]
        assert seen.size > 0.5 * fr.depth.size
        assert 0.45 < seen.min() and seen.max() < 4.1
    # Frame 0 of the segment is posed frame 0's view; 1° a frame after.
    np.testing.assert_allclose(inputs.frames[0].T_cw, inputs.posed[0].T_cw,
                               atol=1e-6)
    assert kr.rotation_deg(inputs.frames[1].T_cw, inputs.frames[0].T_cw) \
        == pytest.approx(1.0, abs=0.05)
    again = kinfu_track.Inputs(cell.config, cell.traffic, 99)
    for a, b in zip(frames, again.posed + again.frames):
        np.testing.assert_array_equal(a.depth, b.depth)


def test_look_at_agrees_with_the_port():
    from objective_slam_tpu_torch.utils import synthetic
    eye, target = (1.4, 0.3, 0.6), (0.0, 0.0, 0.05)
    np.testing.assert_allclose(kinfu_orbit.look_at(eye, target),
                               synthetic.look_at(eye, target), atol=1e-6)

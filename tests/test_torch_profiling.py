"""The port's timing helpers (objective_slam_tpu_torch.utils.profiling) on
the CPU: the statistics of Timings, the log line of phase, which held
results phase waits for, a chrome trace written by trace, and the spans
that the matcher records while a profiler runs (and only then)."""

import dataclasses
import json
import logging
import math
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from objective_slam_tpu.utils import profiling as jprof
import objective_slam_tpu_torch as pt
from objective_slam_tpu_torch.models import drost
from objective_slam_tpu_torch.utils import profiling, synthetic


def test_timings_summary_matches_jax_package():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0, 10.0]
    t, tj = profiling.Timings(), jprof.Timings()
    for x in xs:
        t.add("a", x)
        tj.add("a", x)
    t.add("b", 7.0)
    tj.add("b", 7.0)
    assert t.summary() == tj.summary()
    assert t.summary()["a"] == {"mean_ms": 25.0 / 6, "min_ms": 1.0,
                                "p50_ms": 4.0, "max_ms": 10.0, "count": 6}


def test_phase_logs_and_records(caplog):
    timings = profiling.Timings()
    with caplog.at_level(logging.DEBUG, logger="objective_slam_tpu_torch"):
        with profiling.phase("generate PPFs", timings) as hold:
            hold.append(torch.ones(4) * 2)
    assert len(timings.samples["generate PPFs"]) == 1
    assert timings.samples["generate PPFs"][0] >= 0.0
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Time to generate PPFs: ") and m.endswith(" ms")
               for m in msgs), msgs


@dataclasses.dataclass
class _Result:
    pose: torch.Tensor
    count: int


def test_phase_waits_only_for_tensors_on_the_card(monkeypatch):
    """CPU tensors, tuples and dataclasses of them, and plain values need
    no synchronize; a tensor on the card inside any of them would get one
    (torch.cuda.synchronize is replaced to record the call)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    held = [torch.zeros(2), (torch.zeros(1), 3), _Result(torch.eye(4), 1),
            [7, None], 7, None]
    for h in held:
        with profiling.phase("cpu work") as hold:
            hold.append(h)
    with profiling.phase("nothing held"):
        pass
    assert calls == []
    assert profiling._cuda_device(held[2]) is None
    assert profiling._cuda_device(torch.device("cpu")) is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    path = tmp_path / "prof" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.fixture(autouse=True)
def empty_span_log():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_without_profiler_is_the_shared_noop(monkeypatch):
    """No profiler: `span` returns the one shared no-op, opens no
    record_function, reads no clock and records nothing."""
    def boom(*a, **k):
        raise AssertionError("a span without a profiler did work")
    with monkeypatch.context() as m:
        m.setattr(profiling.time, "time_ns", boom)
        m.setattr(torch.profiler, "record_function", boom)
        first, second = profiling.span("a"), profiling.span("b")
        with first:
            with second:
                pass
    assert first is second is profiling._NO_SPAN
    assert profiling.spans() == []


def test_span_log_nests_on_the_profilers_clock():
    """Under the profiler: records with the right parents, and stamps
    within a median of 50 us of the profiler's own record of each span
    (both on the Unix-epoch clock)."""
    x = torch.ones(64)
    with _cpu_profile() as prof:
        for _ in range(100):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    x = x * 1.5
    log = profiling.spans()
    assert [s.name for s in log] == ["outer", "inner"] * 100
    for i, s in enumerate(log):
        assert s.parent == (-1 if s.name == "outer" else i - 1)
        assert s.start_ns <= s.end_ns
        if s.name == "inner":
            outer = log[s.parent]
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    theirs = {}
    for e in sorted((e for e in prof.profiler.kineto_results.events()
                     if e.is_user_annotation()), key=lambda e: e.start_ns()):
        theirs.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    seen, gaps = {}, []
    for s in log:
        k = seen[s.name] = seen.get(s.name, -1) + 1
        a, b = theirs[s.name][k]
        gaps += [abs(s.start_ns - a), abs(s.end_ns - b)]
    assert statistics.median(gaps) < 50_000, sorted(gaps)[::20]


def test_span_closed_after_clear_is_dropped():
    with _cpu_profile():
        with profiling.span("kept before clear"):
            profiling.clear_spans()
            with profiling.span("after"):
                pass
    assert [(s.name, s.parent) for s in profiling.spans()] == [("after", -1)]


def test_phase_opens_a_span():
    timings = profiling.Timings()
    with _cpu_profile():
        with profiling.phase("gather", timings) as hold:
            with profiling.span("inside"):
                hold.append(torch.ones(3))
    assert [(s.name, s.parent) for s in profiling.spans()] == [
        ("gather", -1), ("inside", 0)]
    assert len(timings.samples["gather"]) == 1


@pytest.fixture(scope="module")
def small_match():
    """A blob planted in clutter; max_poses large enough that top-K does
    not saturate, so one sized match and no ladder."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    mp, mn = synthetic.blob_cloud(rng, 100)
    cp, cn = synthetic.clutter_cloud(rng, 200)
    sp, sn, _ = synthetic.plant_model(rng, mp, mn, cp, cn)
    cfg = pt.PPFConfig(max_poses=256, ref_point_df=2, refine_icp=True,
                       icp_iterations=3)
    desc = pt.build_model_description(mp, mn, cfg, device="cpu")
    yield desc, sp, sn, cfg
    torch.set_num_threads(n)


def _tree(log):
    """{index: [names of its children]} and the roots' names."""
    kids = {i: [] for i in range(len(log))}
    for s in log:
        if s.parent >= 0:
            kids[s.parent].append(s.name)
    return kids, [s.name for s in log if s.parent < 0]


@pytest.mark.parametrize("carried", [False, True],
                         ids=["without-state", "carried-state"])
def test_match_with_state_spans(small_match, carried):
    desc, sp, sn, cfg = small_match
    state = drost.match_with_state(desc, sp, sn, cfg)[1] if carried \
        else None
    assert profiling.spans() == []                  # no profiler yet
    with _cpu_profile():
        res, caps = drost.match_with_state(desc, sp, sn, cfg, state=state)
    assert not bool(res.topk_saturated) and caps.max_poses == 256
    log = profiling.spans()
    kids, roots = _tree(log)
    names = [s.name for s in log]
    assert roots == ["drost.match"]
    assert names.count("drost.count") == (0 if carried else 1)
    assert names.count("drost.core") == 1
    core = names.index("drost.core")
    assert log[core].parent == 0
    assert kids[core] == ["drost.keys", "drost.vote", "drost.topk",
                          "drost.cluster", "icp.refine"]
    assert kids[names.index("icp.refine")] == ["icp.iteration"] * 3
    assert names.count("icp.iteration") == cfg.icp_iterations
    # The host's reads of device values: the carried flags, or the count
    # pass's totals and the ladder's saturation flag.
    syncs = [log[s.parent].name for s in log if s.name == "drost.sync"]
    assert syncs == (["drost.match"] if carried
                     else ["drost.count", "drost.match"])


def test_match_ladder_has_one_core_per_rung():
    """match() with max_poses 2 climbs the top-K ladder: one count pass
    and one drost.core per rung, all under one drost.match."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = np.random.default_rng(2)
        mp, mn = synthetic.blob_cloud(rng, 90)
        sp, sn, _ = synthetic.plant_model(rng, mp, mn)
        cfg = pt.PPFConfig(max_poses=2)
        desc = pt.build_model_description(mp, mn, cfg, device="cpu")
        _, caps = drost._match_loop(desc, sp, sn, cfg, None, None, None,
                                    None, 8192)
        rungs = 1 + round(math.log2(caps.max_poses / cfg.max_poses))
        assert rungs >= 2 and caps.max_poses == 2 ** rungs
        with _cpu_profile():
            drost.match(desc, sp, sn, cfg)
    finally:
        torch.set_num_threads(n)
    log = profiling.spans()
    names = [s.name for s in log]
    assert _tree(log)[1] == ["drost.match"]
    assert names.count("drost.core") == names.count("drost.count") == rungs
    assert all(log[s.parent].name == "drost.match" for s in log
               if s.name in ("drost.core", "drost.count"))


def test_match_result_equal_with_profiler_on_and_off(small_match):
    desc, sp, sn, cfg = small_match
    off, caps_off = drost.match_with_state(desc, sp, sn, cfg)
    with _cpu_profile():
        on, caps_on = drost.match_with_state(desc, sp, sn, cfg)
    assert caps_on == caps_off
    for name, a, b in zip(drost.MatchResult._fields, off, on):
        assert torch.equal(a, b), name
    assert profiling.spans()

"""The readers of the program's spans (metrics/program_spans.py and the six
metrics on it): traced toy cells of both configurations on the CPU, a log
on another clock, a program without a span log, and the arithmetic of the
per-span table on a trace written by hand."""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import REPO, toy

from benchmark import harness, tracing
from benchmark.metrics import program_spans
from objective_slam_tpu_torch.utils import profiling

STAGES = ("prep.ms_per_pose", "vote.ms_per_pose", "select.ms_per_pose",
          "icp.ms_per_pose", "host.sync_ms_per_pose")
NEW = STAGES + ("drost.sizing_pct",)
CELLS = ("binpick-serve", "binpick-oneshot", "uwa-analog-sweep")


@pytest.fixture(scope="module")
def traced():
    """Each cell's toy, traced: its result line, the RunView its readers
    read and the program's span log."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    views, out = [], {}

    class Keep(harness.RunView):
        def __init__(self, *args):
            super().__init__(*args)
            views.append(self)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(harness, "RunView", Keep)
            for name in CELLS:
                profiling.clear_spans()
                cell = toy(harness.find_cell(manifest, name))
                line, _ = harness.run_cell(cell, 5, 0.5, True, "cpu",
                                           time.perf_counter())
                out[name] = (line, views[-1], profiling.spans())
    finally:
        torch.set_num_threads(n)
        profiling.clear_spans()
    return out


def _fresh(view):
    """The same run, with nothing of the readers cached on it."""
    return harness.RunView(view.records, view.window_s, view.setup_s,
                           view.peak_bytes, view.trace, view._work_fn)


def _read(name, run):
    return harness.load_reader(name).read(run)


@pytest.mark.parametrize("cell", CELLS)
def test_new_metrics_are_numbers(traced, cell):
    line, _, log = traced[cell]
    assert log
    for name in NEW:
        value = line["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value), name
        assert value >= 0.0, name
    assert line["metrics"]["drost.sizing_pct"]["value"] <= 100.0


@pytest.mark.parametrize("cell", CELLS)
def test_stages_fit_in_the_mean_latency(traced, cell):
    """The stages and the host's syncs are disjoint parts of a request."""
    line, view, _ = traced[cell]
    mean_ms = 1e3 * sum(r.latency_s for r in view.records) / len(
        view.records)
    assert sum(line["metrics"][m]["value"] for m in STAGES) <= mean_ms


def test_sizing_share_lower_with_carried_state(traced):
    """Carried caps skip the count pass and the ladder."""
    carried = traced["binpick-serve"][0]["metrics"]["drost.sizing_pct"]
    oneshot = traced["binpick-oneshot"][0]["metrics"]["drost.sizing_pct"]
    assert carried["value"] < oneshot["value"]


def _shift_one_second(log):
    return [s._replace(start_ns=s.start_ns + 10 ** 9,
                       end_ns=s.end_ns + 10 ** 9) for s in log]


def _monotonic_clock(log):
    off = time.monotonic_ns() - time.time_ns()
    return [s._replace(start_ns=s.start_ns + off, end_ns=s.end_ns + off)
            for s in log]


@pytest.mark.parametrize("restamp", [_shift_one_second, _monotonic_clock],
                         ids=["shifted-one-second", "monotonic-clock"])
@pytest.mark.parametrize("cell", CELLS)
def test_log_on_another_clock_is_assigned_to_no_request(
        traced, monkeypatch, cell, restamp):
    _, view, log = traced[cell]
    assert program_spans.assign(_fresh(view), log) is not None
    other = restamp(log)
    assert program_spans.assign(_fresh(view), other) is None
    monkeypatch.setattr(program_spans, "_program_log", lambda: other)
    run = _fresh(view)
    assert all(_read(name, run) is None for name in NEW)


def test_program_without_span_log_reads_nothing(traced, monkeypatch):
    """A program whose profiling module has no span log (the parent of
    this change) gives no number and no error."""
    _, view, _ = traced["binpick-oneshot"]
    monkeypatch.delattr(profiling, "spans")
    run = _fresh(view)
    assert all(_read(name, run) is None for name in NEW)


def test_untraced_run_reads_nothing():
    run = SimpleNamespace(trace=None, records=[])
    assert program_spans.assign(run, [profiling.Span("a", 0, 1, -1)]) \
        is None


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


def test_breakdown_by_hand(monkeypatch):
    """One request [0, 1000) ns: drost.match [10, 990) holding drost.core
    [100, 900) holding drost.vote [200, 600); device work at [150, 250)
    and [500, 700); launches at 120 (core's self time), 300 (vote) and
    950 (match's self time); aten::mm on the host at [350, 480)."""
    trace = tracing.TraceSummary([
        _Event("benchmark.request.0", 0, 1000, annotation=True),
        _Event("cudaLaunchKernel", 120, 125),
        _Event("cudaLaunchKernel", 300, 305),
        _Event("cudaLaunchKernelExC", 950, 955),
        _Event("aten::mm", 350, 480),
        _Event("k", 150, 250, cuda=True),
        _Event("k", 500, 700, cuda=True)], 1e-6)
    log = [profiling.Span("drost.match", 10, 990, -1),
           profiling.Span("drost.core", 100, 900, 0),
           profiling.Span("drost.vote", 200, 600, 1)]
    rec = SimpleNamespace(n=0, latency_s=1e-6)
    run = harness.RunView([rec], 1e-6, 0.0, 0, trace, None)
    t = program_spans.assign(run, log)
    assert t.poses == 1 and [s.request for s in t.stages] == [0, 0, 0]
    b = program_spans.breakdown(run, t)
    # spans, wall, self, launches in self, device busy in self
    assert b.rows["drost.match"] == [1, 980, 180, 1, 0]
    assert b.rows["drost.core"] == [1, 800, 400, 1, 50 + 100]
    assert b.rows["drost.vote"] == [1, 400, 400, 1, 50 + 100]
    assert b.cover == pytest.approx(98.0)
    # Idle gaps [0, 150), [250, 500), [700, 1000): their middles lie in
    # match (no host operator), vote (in aten::mm) and core.
    assert b.idle_ns == 150 + 250 + 300 and b.unspanned_ns == 0
    assert b.idle_by == {("drost.match", "python"): 150,
                         ("drost.vote", "aten::mm"): 250,
                         ("drost.core", "python"): 300}
    monkeypatch.setattr(program_spans, "_program_log", lambda: log)
    fresh = _fresh(run)
    assert program_spans.ms_per_pose(fresh, ("drost.vote",)) == 400 / 1e6
    assert program_spans.ms_per_pose(fresh, ("drost.count",)) is None
    # An outermost span that overlaps the request but reaches past it by
    # more than the slack: the log is on another clock.
    reach = 2 * program_spans.CLOCK_SLACK_NS
    wide = [profiling.Span("drost.match", 500 - reach, 500 + reach, -1)]
    assert program_spans.assign(run, log + wide) is None
    late = [profiling.Span("pointcloud.voxel_downsample", 900,
                           1000 + 2 * program_spans.CLOCK_SLACK_NS, -1)]
    assert program_spans.assign(run, log + late) is None
    # Spans in no request are left out, not refused.
    assert program_spans.assign(
        run, log + [profiling.Span("drost.match", 5000, 6000, -1)]) \
        .stages == t.stages

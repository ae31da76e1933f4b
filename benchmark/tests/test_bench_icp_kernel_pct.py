"""icp.kernel_pct on span logs written by hand: the share of `icp.refine`
spans that hold an `icp.kernel` span."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, tracing
from benchmark.metrics import program_spans
from objective_slam_tpu_torch.utils import profiling


class _Request:
    """The profiler's record of one `benchmark.request.<n>` span."""

    def __init__(self, n, start, end):
        self.v = (f"{tracing.REQUEST_SPAN}{n}", start, end)

    def is_user_annotation(self):
        return True

    def name(self):
        return self.v[0]

    def start_ns(self):
        return self.v[1]

    def end_ns(self):
        return self.v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return 1


def _request_log(n, kernel):
    """Request n over [1000 n, 1000 n + 1000) ns: drost.match holding
    icp.refine, which holds icp.kernel or two icp.iteration spans."""
    a = 1000 * n
    log = [("drost.match", a + 10, a + 990, -1),
           ("icp.refine", a + 100, a + 900, 0)]
    if kernel:
        log.append(("icp.kernel", a + 200, a + 800, 1))
    else:
        log += [("icp.iteration", a + 200, a + 400, 1),
                ("icp.iteration", a + 500, a + 700, 1)]
    return log


def _read(monkeypatch, kernels):
    """icp.kernel_pct of requests 0 .. len(kernels) − 1, request n's
    refinement holding a kernel span iff kernels[n]."""
    log = []
    for n, kernel in enumerate(kernels):
        base = len(log)
        log += [profiling.Span(name, a, b, p + base if p >= 0 else -1)
                for name, a, b, p in _request_log(n, kernel)]
    trace = tracing.TraceSummary(
        [_Request(n, 1000 * n, 1000 * n + 1000) for n in range(len(kernels))],
        1e-6 * len(kernels))
    records = [SimpleNamespace(n=n, latency_s=1e-6)
               for n in range(len(kernels))]
    run = harness.RunView(records, 1e-6 * len(kernels), 0.0, 0, trace, None)
    monkeypatch.setattr(program_spans, "_program_log", lambda: log)
    return harness.load_reader("icp.kernel_pct").read(run)


@pytest.mark.parametrize("kernels,want", [
    ([True, True, True, True], 100.0),
    ([True, False, True, False], 50.0),
    ([False, False], 0.0),
])
def test_share_of_refinements_with_a_kernel_span(monkeypatch, kernels, want):
    assert _read(monkeypatch, kernels) == pytest.approx(want)


def test_no_refinement_reads_nothing(monkeypatch):
    trace = tracing.TraceSummary([_Request(0, 0, 1000)], 1e-6)
    run = harness.RunView([SimpleNamespace(n=0, latency_s=1e-6)], 1e-6, 0.0,
                          0, trace, None)
    monkeypatch.setattr(program_spans, "_program_log", lambda: [
        profiling.Span("drost.match", 10, 990, -1),
        profiling.Span("drost.core", 100, 900, 0)])
    assert harness.load_reader("icp.kernel_pct").read(run) is None

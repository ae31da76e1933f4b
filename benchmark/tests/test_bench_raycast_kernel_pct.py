"""kinfu.raycast_kernel_pct on span logs written by hand: the share of
`tsdf.raycast` spans that hold a `tsdf.raycast_kernel` span."""

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
    """Request n over [1000 n, 1000 n + 1000) ns: tsdf.track holding
    tsdf.raycast, which holds tsdf.raycast_kernel or nothing (the plain
    version), and tsdf.gauss_newton holding tsdf.gn_kernel, then
    tsdf.integrate."""
    a = 1000 * n
    log = [("tsdf.track", a + 10, a + 700, -1),
           ("tsdf.raycast", a + 20, a + 300, 0)]
    if kernel:
        log.append(("tsdf.raycast_kernel", a + 30, a + 290, 1))
    g = len(log)
    log += [("tsdf.gauss_newton", a + 310, a + 600, 0),
            ("tsdf.gn_kernel", a + 320, a + 590, g),
            ("tsdf.integrate", a + 710, a + 990, -1)]
    return log


def _run(n_requests):
    trace = tracing.TraceSummary(
        [_Request(n, 1000 * n, 1000 * n + 1000) for n in range(n_requests)],
        1e-6 * n_requests)
    records = [SimpleNamespace(n=n, latency_s=1e-6)
               for n in range(n_requests)]
    return harness.RunView(records, 1e-6 * n_requests, 0.0, 0, trace, None)


def _read(monkeypatch, kernels):
    """kinfu.raycast_kernel_pct of requests 0 .. len(kernels) − 1, request
    n's raycast span holding a kernel span iff kernels[n]."""
    log = []
    for n, kernel in enumerate(kernels):
        base = len(log)
        log += [profiling.Span(name, a, b, p + base if p >= 0 else -1)
                for name, a, b, p in _request_log(n, kernel)]
    monkeypatch.setattr(program_spans, "_program_log", lambda: log)
    return harness.load_reader("kinfu.raycast_kernel_pct").read(
        _run(len(kernels)))


@pytest.mark.parametrize("kernels,want", [
    ([True, True, True, True], 100.0),
    ([True, False, False, False], 25.0),
    ([False, False], 0.0),
])
def test_share_of_raycasts_with_a_kernel_span(monkeypatch, kernels, want):
    assert _read(monkeypatch, kernels) == pytest.approx(want)


def test_a_kernel_span_elsewhere_is_not_counted(monkeypatch):
    """A `tsdf.raycast_kernel` span whose parent is not a `tsdf.raycast`
    span (here the request's root) counts for no raycast."""
    log = [profiling.Span("tsdf.track", 10, 700, -1),
           profiling.Span("tsdf.raycast", 20, 300, 0),
           profiling.Span("tsdf.raycast_kernel", 400, 500, 0)]
    monkeypatch.setattr(program_spans, "_program_log", lambda: log)
    assert harness.load_reader("kinfu.raycast_kernel_pct").read(_run(1)) \
        == pytest.approx(0.0)


def test_no_raycast_reads_nothing(monkeypatch):
    """A request without tracking (a PPF match, or a frame only fused)."""
    monkeypatch.setattr(program_spans, "_program_log", lambda: [
        profiling.Span("drost.match", 10, 990, -1),
        profiling.Span("tsdf.integrate", 100, 900, 0)])
    assert harness.load_reader("kinfu.raycast_kernel_pct").read(_run(1)) \
        is None


def test_no_span_log_reads_nothing(monkeypatch):
    """A program that records no spans: nothing, and no error."""
    monkeypatch.setattr(program_spans, "_program_log", lambda: None)
    assert harness.load_reader("kinfu.raycast_kernel_pct").read(_run(1)) \
        is None

"""The kernels' yardstick: the work of a vote pass, counted by hand."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import tracing
from benchmark.metrics import kernel_work

# bench seed 0: 564 reference rows of 2,760 voxels, a 280-point model.
W = kernel_work.Work(ref_rows=564, scene_points=2760, model_points=280,
                     occupied_keys=429, model_pairs=78_000,
                     voting_pairs=120_000, votes=46_218_777)


def test_bytes_and_ops_by_hand():
    table = 429 * 12 + 78_000 * 8          # key, first, count; mr, α_m
    acc = 564 * 280 * 31 * 4               # int32 cells, 31 α bins
    pairs = 564 * 2760 * 4 + 120_000 * 4   # a word a pair; α of voters
    assert kernel_work.tally_bytes(W) == table + acc == 20_211_228
    assert kernel_work.expansion_bytes(W) == pairs == 6_706_560
    assert kernel_work.bound_s(W, expands=False) == pytest.approx(
        20_211_228 / 3.35e12)
    assert kernel_work.bound_s(W, expands=True) == pytest.approx(
        26_917_788 / 3.35e12)


def test_bound_by_ops_when_votes_dominate():
    w = kernel_work.Work(1, 1, 1, 0, 0, 0, votes=10 ** 12)
    assert kernel_work.bound_s(w, expands=True) == pytest.approx(
        10 ** 12 / 67e12)


class _Trace:
    """K1 records by request number."""

    def __init__(self, by_request):
        self._d = by_request

    def by_request(self, name):
        return self._d.get(name, {})

    def kernel_durations(self, name):
        return [d for ds in self.by_request(name).values() for d in ds]


def test_roofline_share_over_wholly_traced_requests():
    req = SimpleNamespace(scan=0, model=0)
    recs = [SimpleNamespace(n=n, req=req,
                            outcome=SimpleNamespace(k1_launches=2))
            for n in range(3)]
    # Request 2 lost one record: it is left out, not averaged in.
    run = SimpleNamespace(records=recs, work=lambda r: W, trace=_Trace(
        {"block_tally_kernel": {0: [1e-5, 3e-5], 1: [2e-5, 2e-5],
                                2: [9e-5]}}))
    share = kernel_work.roofline_pct(run, "block_tally_kernel",
                                     "k1_launches", expands=False)
    assert share == pytest.approx(
        100 * 4 * kernel_work.bound_s(W, expands=False) / 8e-5)
    run.trace = _Trace({})
    assert kernel_work.roofline_pct(run, "block_tally_kernel",
                                    "k1_launches", expands=False) is None


class _Event:
    def __init__(self, name, start, end, cuda, annotation=False):
        self._v = (name, start, end, cuda, annotation)

    def is_user_annotation(self):
        return self._v[4]

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def start_thread_id(self):
        return 1


def test_trace_assigns_kernels_to_the_request_spans():
    events = [_Event("benchmark.request.0", 0, 100, False, True),
              _Event("benchmark.request.1", 200, 300, False, True),
              # the spans' mirrors on the device: not device work
              _Event("benchmark.request.0", 50, 60, True, True),
              _Event("benchmark.request.1", 250, 290, True, True),
              _Event("aten::mm", 210, 220, False),
              _Event("block_tally_kernel", 50, 60, True),
              _Event("block_tally_kernel", 250, 270, True),
              _Event("block_tally_kernel", 280, 290, True),
              _Event("other_kernel", 10, 20, True)]
    summary = tracing.TraceSummary(events, 1.0)
    assert summary.spans == {0: (0, 100), 1: (200, 300)}
    got = summary.by_request("block_tally_kernel")
    assert got[0] == pytest.approx([1e-8])
    assert got[1] == pytest.approx([2e-8, 1e-8])
    assert summary.kernels == 4
    assert summary.busy_s == pytest.approx(5e-8)

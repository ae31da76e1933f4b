"""The port's timing helpers (objective_slam_tpu_torch.utils.profiling) on
the CPU: the statistics of Timings, the log line of phase, which held
results phase waits for, and a chrome trace written by trace."""

import dataclasses
import json
import logging

import torch

from objective_slam_tpu.utils import profiling as jprof
from objective_slam_tpu_torch.utils import profiling


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

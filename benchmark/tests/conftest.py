"""CPU tests of the benchmark. They import no JAX. Tests that need the
card take the `card` fixture, which skips them where no CUDA device is
available; run them on the card with `python -m pytest benchmark/tests -m
card`."""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU keys may differ by an ulp with several threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy(cell):
    """The cell at a size the CPU runs in seconds: a small model, small
    scans, a short pool, a small judged sample."""
    cfg = copy.deepcopy(cell.config)
    traffic = dict(cell.traffic)
    if cfg["scenes"]["generator"] == "bin_picking":
        cfg["models"]["n_raw"] = 2000
        cfg["scenes"].update(n_total=5000, n_instances=2, n_inst_pts=900)
    else:
        cfg["scene_leaf"] = 40.0
    traffic["pool"] = 2
    cfg["judge"]["sample"] = 2
    return cell._replace(config=cfg, traffic=traffic)


@pytest.fixture
def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())

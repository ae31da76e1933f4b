"""Timing and tracing helpers (port of ``objective_slam_tpu.utils.profiling``).

The reference times PPF generation and lookup with cudaEvent timers under
``#ifdef DEBUG`` ("Time to generate PPFs", scene.cu:72-98; "Time to lookup
model", model.cu:271-305). Here:

  * ``phase(name)`` — a wall-clock timer that ends with
    ``torch.cuda.synchronize`` when what it holds lies on the card, and logs
    "Time to <name>: X ms" at debug level;
  * ``trace(log_dir)`` — a ``torch.profiler`` trace of CPU and CUDA
    activity, written into ``log_dir`` as a chrome trace;
  * ``Timings`` — per-phase statistics for benchmark reports;
  * ``span(name)`` — a named stage of the program, recorded only while a
    torch profiler runs: a ``record_function`` in the profiler's trace and
    a record ``(name, start_ns, end_ns, parent)`` in an in-memory log
    (``spans()``, ``clear_spans()``), stamped on the Unix-epoch clock the
    profiler stamps its own records with. With no profiler running a span
    costs one check of the profiler's state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from collections import defaultdict
from typing import NamedTuple

import torch

log = logging.getLogger("objective_slam_tpu_torch")


class Timings:
    """Accumulates per-phase wall times (ms)."""

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    def add(self, name: str, ms: float) -> None:
        self.samples[name].append(ms)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "mean_ms": sum(xs) / len(xs),
                "min_ms": xs_sorted[0],
                "p50_ms": xs_sorted[len(xs) // 2],
                "max_ms": xs_sorted[-1],
                "count": len(xs),
            }
        return out


class Span(NamedTuple):
    """One span of the log: `parent` is the index in the log of the span
    that was open around it, or -1."""
    name: str
    start_ns: int
    end_ns: int
    parent: int


# What a span returns while no profiler runs: one shared context that does
# nothing.
_NO_SPAN = contextlib.nullcontext()
# The log, in the order the spans opened, and the indices of the spans
# open now (the innermost last).
_LOG: list[Span] = []
_OPEN: list[int] = []


class _Span:
    __slots__ = ("_name", "_rf", "_i")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        self._i = len(_LOG)
        _LOG.append(Span(self._name, time.time_ns(), -1,
                         _OPEN[-1] if _OPEN else -1))
        _OPEN.append(self._i)

    def __exit__(self, *exc):
        end = time.time_ns()
        if _OPEN and _OPEN[-1] == self._i:      # not cleared meanwhile
            _OPEN.pop()
            _LOG[self._i] = _LOG[self._i]._replace(end_ns=end)
        return self._rf.__exit__(*exc)


def span(name: str):
    """A named stage: ``with profiling.span("drost.vote"): ...``.

    While no torch profiler runs this returns one shared no-op context and
    does nothing else. While one runs, the block is a
    ``torch.profiler.record_function(name)`` and appends a `Span` to the
    log, its stamps taken by time.time_ns() just inside the
    record_function."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(name)


def spans() -> list[Span]:
    """The spans recorded since the last clear_spans(), in the order they
    opened (a span still open has end_ns -1)."""
    return list(_LOG)


def clear_spans() -> None:
    """Empties the log; spans open now are no longer recorded."""
    _LOG.clear()
    _OPEN.clear()


def _cuda_device(x):
    """The CUDA device of the first tensor found in x (a tensor, a tuple or
    list, a dataclass's or NamedTuple's fields), else None."""
    if isinstance(x, torch.Tensor):
        return x.device if x.is_cuda else None
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        for item in x:
            dev = _cuda_device(item)
            if dev is not None:
                return dev
    return None


@contextlib.contextmanager
def phase(name: str, timings: Timings | None = None, result_holder=None):
    """Times a phase. Usage:

        with profiling.phase("generate PPFs") as hold:
            hold.append(some_fn(x))   # the last appended is waited for

    The block's time ends with torch.cuda.synchronize when the last held
    result holds a tensor on the card; work on the CPU is done when it
    returns. Mirrors the reference's '#ifdef DEBUG' event timers
    (scene.cu:72-98). The block is also a `span` of the same name."""
    holder = result_holder if result_holder is not None else []
    with span(name):
        t0 = time.perf_counter()
        yield holder
        if holder:
            dev = _cuda_device(holder[-1])
            if dev is not None:
                torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    log.debug("Time to %s: %3.1f ms", name, ms)
    if timings is not None:
        timings.add(name, ms)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of CPU and CUDA activity over the block,
    written to ``<log_dir>/trace.json`` (open it in chrome://tracing or
    Perfetto). Yields the profiler, whose ``key_averages()`` sum the time
    by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

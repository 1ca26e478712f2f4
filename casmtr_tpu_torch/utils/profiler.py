"""Region timers of the evaluation (counterpart of
casmtr_tpu/utils/profiler.py): ``build_profiler(None)`` times nothing,
``build_profiler("inference")`` the wall-clock time of each named region,
the card synchronized before each reading of the clock (CUDA runs
asynchronously: without it a region would time its enqueueing)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import torch


class PassThroughProfiler:
    """Times nothing."""

    @contextlib.contextmanager
    def profile(self, name: str):
        yield

    def summary(self) -> str:
        return ""


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class InferenceProfiler(PassThroughProfiler):
    """Wall-clock seconds per call of each named region, the card's queue
    drained at both ends; each region is also a ``torch.profiler``
    annotation."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def profile(self, name: str):
        _sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            _sync()
        self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = [f"{'Region':40s} {'Calls':>6s} {'Mean (s)':>10s} "
                 f"{'Total (s)':>10s}"]
        for name, ts in sorted(self.times.items()):
            lines.append(f"{name:40s} {len(ts):6d} "
                         f"{sum(ts) / len(ts):10.4f} {sum(ts):10.4f}")
        return "\n".join(lines)


def build_profiler(name: Optional[str]):
    """None: PassThroughProfiler; "inference": InferenceProfiler."""
    if name is None:
        return PassThroughProfiler()
    if name == "inference":
        return InferenceProfiler()
    raise ValueError(f"unknown profiler {name}")

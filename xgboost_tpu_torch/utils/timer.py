"""Per-label accumulating timers over the telemetry layer (the port of the
JAX package's ``utils/timer.py``; reference ``common::Monitor``,
``src/common/timer.h:16,47``).

A ``Monitor`` keeps label -> accumulated wall time and call count, printed
at verbosity >= 3; every ``stop`` also feeds the
``monitor_seconds{monitor=,section=}`` histogram of the metrics registry
and records a span on the active trace, so the learner's sections
(``GetGradient``, ``GetBinned``, ``BoostOneRound``) appear in timelines and
exposition alike. The times are host-clock intervals: a section never
synchronizes the device.

Device time is ``torch.profiler``'s (``profiler_context``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Iterator, Tuple

from ..config import get_config
from ..observability import metrics as _metrics
from ..observability import trace as _trace

__all__ = ["Monitor", "profiler_context"]

_MONITOR_HELP = "Host-side wall time per Monitor section"


class Monitor:
    def __init__(self, label: str):
        self.label = label
        self.stats: Dict[str, Tuple[float, int]] = {}
        self._open: Dict[str, int] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter_ns()

    def stop(self, name: str) -> None:
        t0 = self._open.pop(name, None)
        if t0 is None:
            return
        t1 = time.perf_counter_ns()
        dt = (t1 - t0) * 1e-9
        acc, n = self.stats.get(name, (0.0, 0))
        self.stats[name] = (acc + dt, n + 1)
        _metrics.REGISTRY.histogram("monitor_seconds", _MONITOR_HELP).labels(
            monitor=self.label, section=name).observe(dt)
        _trace.emit(name, t0, t1, monitor=self.label)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def report(self) -> str:
        lines = [f"======== Monitor: {self.label} ========"]
        for name, (acc, n) in sorted(self.stats.items()):
            lines.append(f"{name}: {acc * 1e3:.3f}ms, {n} calls")
        return "\n".join(lines)

    def maybe_print(self) -> None:
        if get_config()["verbosity"] >= 3 and self.stats:
            print(self.report(), file=sys.stderr, flush=True)


@contextlib.contextmanager
def profiler_context(log_dir: str) -> Iterator[None]:
    """Profile everything inside the context with ``torch.profiler`` (host
    activity, and CUDA activity where a card is present) and write the
    Chrome trace to ``log_dir/profile.json`` (reference analog: NVTX
    ranges, ``src/common/timer.h:52``)::

        with xgboost_tpu_torch.profiler_context("prof"):
            xgboost_tpu_torch.train(params, dtrain, 50)
    """
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "profile.json"))

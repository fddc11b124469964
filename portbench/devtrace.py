"""Reduction of a ``torch.profiler`` window to the numbers the per-layer
metrics and the ``breakdown`` read.

Every device activity the profiler recorded (kernels, copies, fills) is
an interval on the card's timeline. ``busy_s`` is the length of their
union; the window's own length comes from the host clock around it (both
ends of the window end in a synchronize). The idle gaps are the holes in
that union, each named by the innermost program span and the innermost
host operation open at its midpoint (the profiler's host events and the
program's spans are both on the wall clock).
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]

#: name fragments of the level-histogram launches: kernel D (its routing
#: launch and the histogram) and kernel A (routing and histogram)
LEVEL_HIST_KERNELS = ("hoisted_kernel", "route_kernel", "level_hist_kernel")


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``[start, end)`` intervals as sorted disjoint ones."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_ns(intervals: Iterable[Interval]) -> int:
    return sum(e - s for s, e in union(intervals))


def gaps(merged: Sequence[Interval]) -> List[Interval]:
    return [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]


def _innermost(events: Sequence[Tuple[int, int, str]], t: int) -> Optional[str]:
    best = None
    for s, e, name in events:
        if s <= t < e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return None if best is None else best[1]


def _events(prof):
    """``(device [(start_ns, end_ns, name)], host [...])`` of a finished
    profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (int(e.start_ns()), int(e.end_ns()), e.name())
        if e.device_type() == DeviceType.CUDA:
            dev.append(rec)
        elif e.device_type() == DeviceType.CPU:
            host.append(rec)
    return dev, host


def reduce(prof, window_s: float, rounds: int, spans: Sequence[dict] = (),
           span_epoch_unix_ns: int = 0, top: int = 10) -> Dict:
    """The profile's ``busy_s``, ``window_s``, ``rounds``, device seconds
    by kernel name, the level-histogram launches' seconds, and the
    ``breakdown`` (``top`` device operations by time, ``top`` longest idle
    gaps by what the host was doing). ``spans`` are the program's trace
    events (Chrome ``X`` events, ``ts``/``dur`` in microseconds after
    ``span_epoch_unix_ns``)."""
    dev, host = _events(prof)
    merged = union((s, e) for s, e, _ in dev)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) / 1e9
    level_s = sum(v for k, v in by_name.items()
                  if any(f in k for f in LEVEL_HIST_KERNELS))
    prog = [(span_epoch_unix_ns + int(ev["ts"]) * 1000,
             span_epoch_unix_ns + (int(ev["ts"]) + int(ev.get("dur", 0))) * 1000,
             ev["name"]) for ev in spans if ev.get("ph") == "X"]
    idle = sorted(gaps(merged), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in idle:
        mid = (s + e) // 2
        where = [_innermost(prog, mid) or "-", _innermost(host, mid) or "-"]
        named.append([" / ".join(where), (e - s) / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_ns(merged) / 1e9,
        "window_s": window_s,
        "rounds": rounds,
        "level_hist_s": level_s,
        "breakdown": {"device_ops": [[k, v] for k, v in ops],
                      "idle_gaps": named},
    }

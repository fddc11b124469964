"""Trace summarization: ``python -m xgboost_tpu_torch trace-report <file>``
(the port of the JAX package's ``observability/report.py``; its report,
line for line).

Reads a Chrome trace-event file written by ``observability.trace`` (any of
the accepted forms; see ``load_trace``) and prints:

- per-span-name totals: call count, total (inclusive) time, **self time**
  (inclusive minus time spent in nested spans on the same rank and
  thread), ranked by self time: where a round's milliseconds went;
- per-category totals: the Chrome ``cat`` field, with uncategorized spans
  counted as ``train`` and the known collective span names as
  ``collective``;
- the ``grow`` category's spans by name, where a trace has them;
- with ``--steps``, the port's ``step`` category by name (``step/<op>``:
  the level loop's ops, ``_level_update``'s sub-ops and the round's ops
  outside the grower), with the level loop's total over the ``step/<op>``
  spans of the grower's loop alone: the nested ``step/level_update/*``
  spans are not added to it a second time (without the flag the report
  stays the JAX package's, line for line);
- per-rank (Chrome ``pid``) totals;
- counts of instant events.

Self time is reconstructed per (pid, tid) track with a stack sweep over
the complete ('X') events sorted by start time: an event strictly
contained in the open event above it is a child, and its duration is
subtracted from the parent's self time.

Several inputs (and globs the shell did not expand, ``trace.json.rank*``)
merge into one report: the per-rank files of a run of several processes
carry their rank as the Chrome ``pid``, so the per-rank totals stay apart
after the merge. Any unreadable input makes the exit status non-zero (the
readable inputs still report).
"""

from __future__ import annotations

import glob as _glob
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Tuple

from .trace import load_trace

__all__ = ["summarize", "format_report", "main"]


def _self_times(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """name -> self time (us), via a per-track stack sweep."""
    tracks: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = defaultdict(list)
    for ev in events:
        tracks[(ev.get("pid", 0), ev.get("tid", 0))].append(ev)
    self_us: Dict[str, float] = defaultdict(float)

    def close(frame: List[Any]) -> None:
        ts, end, name, child_dur = frame
        self_us[name] += max(end - ts - child_dur, 0.0)

    for evs in tracks.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[List[Any]] = []  # [ts, end, name, child_dur]
        for ev in evs:
            ts, dur = ev["ts"], ev.get("dur", 0)
            # pop every open frame that closed before this event starts
            while stack and ts >= stack[-1][1]:
                close(stack.pop())
            if stack:  # nested: charge our duration to the parent
                stack[-1][3] += dur
            stack.append([ts, ts + dur, ev["name"], 0.0])
        while stack:
            close(stack.pop())
    return dict(self_us)


#: uncategorized span names that belong to the collective plane
#: (``collective.py``'s spans)
_COLLECTIVE_NAMES = frozenset(
    {"allreduce", "broadcast", "process_allgather", "psum", "all_gather"})


def _category(ev: Dict[str, Any]) -> str:
    cat = ev.get("cat")
    if cat:
        return str(cat)
    name = str(ev.get("name", ""))
    if name in _COLLECTIVE_NAMES or name.startswith("collective"):
        return "collective"
    return "train"


def summarize(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    events = list(events)
    complete = [e for e in events
                if e.get("ph") == "X" and "ts" in e and "dur" in e]
    instants = [e for e in events if e.get("ph") == "i"]
    per_name: Dict[str, Dict[str, float]] = {}
    per_rank: Dict[int, Dict[str, float]] = {}
    per_cat: Dict[str, Dict[str, float]] = {}
    for ev in complete:
        s = per_name.setdefault(ev["name"], {"count": 0, "total_us": 0.0})
        s["count"] += 1
        s["total_us"] += ev["dur"]
        r = per_rank.setdefault(int(ev.get("pid", 0)),
                                {"count": 0, "total_us": 0.0})
        r["count"] += 1
        r["total_us"] += ev["dur"]
        c = per_cat.setdefault(_category(ev),
                               {"count": 0, "total_us": 0.0})
        c["count"] += 1
        c["total_us"] += ev["dur"]
    for name, su in _self_times(complete).items():
        per_name.setdefault(name, {"count": 0, "total_us": 0.0})[
            "self_us"] = su
    for s in per_name.values():
        s.setdefault("self_us", 0.0)
    inst_counts: Dict[str, int] = defaultdict(int)
    for ev in instants:
        inst_counts[ev["name"]] += 1
    out = {
        "n_events": len(events),
        "n_spans": len(complete),
        "spans": per_name,
        "ranks": per_rank,
        "categories": per_cat,
        # the cat="grow" spans by name (the JAX package's kernel profiler
        # writes them; a merged trace may hold them)
        "grow": _by_name(complete, "grow"),
        "instants": dict(inst_counts),
    }
    per_step = _by_name(complete, "step")
    if per_step:  # only the port's traces have them
        out["step"] = per_step
    return out


def _by_name(complete: List[Dict[str, Any]], cat: str
             ) -> Dict[str, Dict[str, float]]:
    """Count and total time by span name of the category ``cat``."""
    per: Dict[str, Dict[str, float]] = {}
    for ev in complete:
        if _category(ev) != cat:
            continue
        g = per.setdefault(ev["name"], {"count": 0, "total_us": 0.0})
        g["count"] += 1
        g["total_us"] += ev["dur"]
    return per


#: the ``step/<op>`` spans of the grower's level loop; the
#: ``step/level_update/*`` spans nest inside ``step/level_update``
LEVEL_LOOP_STEPS = tuple(f"step/{op}" for op in (
    "prep", "level_hist", "level_update", "level_partition", "finalize",
    "leaf_delta"))


def _ms(us: float) -> str:
    return f"{us / 1000.0:.3f}ms"


def format_report(summary: Dict[str, Any], top: int = 20,
                  steps: bool = False) -> str:
    cats = summary.get("categories", {})
    lines = [
        f"trace: {summary['n_events']} events, "
        f"{summary['n_spans']} spans, {len(summary['ranks'])} rank(s)",
    ]
    if cats:
        lines.append(
            "span time by category: " + ", ".join(
                f"{cat} {_ms(c['total_us'])} ({c['count']} spans)"
                for cat, c in sorted(
                    cats.items(), key=lambda kv: -kv[1]["total_us"])))
    grow = summary.get("grow") or {}
    if grow:
        lines.append("grow breakdown (kernel-profiled substages):")
        for name, g in sorted(grow.items(),
                              key=lambda kv: -kv[1]["total_us"]):
            lines.append(f"  {name:<28} {g['count']:>7} "
                         f"{_ms(g['total_us']):>12}")
    step = (summary.get("step") or {}) if steps else {}
    if step:
        lines.append("step breakdown (program spans of the level loop, "
                     "its sub-ops and the round's other ops):")
        for name, g in sorted(step.items(),
                              key=lambda kv: -kv[1]["total_us"]):
            lines.append(f"  {name:<28} {g['count']:>7} "
                         f"{_ms(g['total_us']):>12}")
        loop = sum(g["total_us"] for name, g in step.items()
                   if name in LEVEL_LOOP_STEPS)
        lines.append(f"  level loop {_ms(loop)} (step/level_update/* "
                     f"nested in step/level_update, not added again)")
    lines += [
        "",
        f"top spans by self time (top {top}):",
        f"  {'name':<28} {'count':>7} {'total':>12} {'self':>12} {'avg':>10}",
    ]
    ranked = sorted(summary["spans"].items(),
                    key=lambda kv: -kv[1]["self_us"])[:top]
    for name, s in ranked:
        avg = s["total_us"] / s["count"] if s["count"] else 0.0
        lines.append(
            f"  {name:<28} {s['count']:>7} {_ms(s['total_us']):>12} "
            f"{_ms(s['self_us']):>12} {_ms(avg):>10}")
    lines.append("")
    lines.append("per-rank totals:")
    for rank in sorted(summary["ranks"]):
        r = summary["ranks"][rank]
        lines.append(
            f"  rank {rank}: {r['count']} spans, {_ms(r['total_us'])}")
    if summary["instants"]:
        lines.append("")
        lines.append("instant events:")
        for name in sorted(summary["instants"]):
            lines.append(f"  {name}: {summary['instants'][name]}")
    return "\n".join(lines)


def expand_inputs(args: List[str]) -> List[str]:
    """Glob-expand each argument (sorted); an argument matching nothing is
    kept as it is, so its load error shows instead of a report on fewer
    files than asked for."""
    paths: List[str] = []
    for pat in args:
        hits = sorted(_glob.glob(pat))
        paths.extend(hits if hits else [pat])
    return paths


def main(argv: List[str]) -> int:
    usage = ("usage: python -m xgboost_tpu_torch trace-report <trace-file|glob>"
             " [more files...] [--top N]")
    if not argv or argv[0] in ("-h", "--help"):
        print(usage, file=sys.stderr)
        return 0 if argv else 1
    steps = "--steps" in argv  # the port's step table
    argv = [a for a in argv if a != "--steps"]
    top = 20
    if "--top" in argv:
        i = argv.index("--top")
        try:
            top = int(argv[i + 1])
        except (IndexError, ValueError):
            print(usage, file=sys.stderr)
            return 1
        argv = argv[:i] + argv[i + 2:]
    rc = 0
    events: List[Dict[str, Any]] = []
    loaded: List[str] = []
    for path in expand_inputs(argv):
        try:
            events.extend(load_trace(path))
        except (OSError, ValueError, KeyError) as e:
            print(f"{path}: unreadable trace: {e}", file=sys.stderr)
            rc = 1
            continue
        loaded.append(path)
    if loaded:
        if len(loaded) > 1:
            print(f"== merged {len(loaded)} trace files ==")
        print(format_report(summarize(events), top=top, steps=steps))
    return rc

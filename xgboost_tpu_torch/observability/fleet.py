"""Cross-rank observability: ``python -m xgboost_tpu_torch obs-report``
(the port of the JAX package's ``observability/fleet.py``, whose outputs
it writes for the same run directory).

Every rank of a run persists its telemetry under ``run_dir/obs/rank<k>/``
(``observability/flight.py``): ``flight.jsonl`` (round records and
events), ``trace.jsonl`` (the span timeline), ``metrics.json`` (the
registry's snapshot) and ``clock.json`` (the wall-clock instant at which
that rank's trace timestamps are zero). The questions of the whole world
(who straggled, when a death was found, what every rank spent) need the
ranks merged; this is that merge, an offline pass over the run directory,
so it also reads what a crashed run left:

- **merged trace**: every rank's events on one clock-aligned timeline
  (each rank's ``ts`` shifted by its recorded clock offset; Chrome ``pid``
  = base rank), the flight events (worker loss, tombstones, quiesce,
  resize, replay, aborts) as instants. Written to
  ``run_dir/obs/merged.trace.json``, loadable in Perfetto.
- **metrics rollup**: counters summed across ranks, gauges maxed,
  histograms merged (sums, counts and buckets added). Written with the
  fleet table to ``run_dir/obs/metrics_rollup.json``.
- **per-round fleet table**: each round's wall time per rank, keyed
  (generation, round), the straggler skew (max - min), and the replayed
  rounds (a round index recorded again by one rank).

Partial data is expected: a SIGKILLed rank's torn last JSONL line is
skipped, a rank that died before its first round has only a meta line,
and a rank without ``clock.json`` keeps unshifted timestamps.

A fleet run directory (``serve-fleet``) holds no ranks but one serving
sink per replica, ``replica<k>/obs/server``: :func:`collect` loads each as
a rank-shaped member after any training ranks, so ``obs-report`` rolls N
replicas up as it rolls up N ranks. :func:`load_obs_dir` loads one such
directory on its own (``serve-report``, ``observability/serve_report.py``).
"""

from __future__ import annotations

import json
import os
import re
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from .trace import load_trace

__all__ = ["collect", "load_obs_dir", "merge_trace", "write_trace",
           "rollup_metrics", "fleet_table", "format_fleet_report", "main"]

_RANK_RE = re.compile(r"^rank(\d+)$")
_REPLICA_RE = re.compile(r"^replica(\d+)$")


class RankObs:
    """One rank's persisted observability files, parsed leniently.
    ``title`` names the merged trace's process lane (the rank, unless a
    merge of several run directories or a fleet replica sets it)."""

    def __init__(self, rank: int, path: str, title: Optional[str] = None):
        self.rank = rank
        self.path = path
        self.title = title if title is not None else f"rank {rank}"
        self.clock_unix_ns: Optional[int] = None
        self.trace_events: List[Dict[str, Any]] = []
        self.flight: List[Dict[str, Any]] = []
        self.metrics: Dict[str, Any] = {}
        self.errors: List[str] = []

    def load(self) -> "RankObs":
        clock = self._read_json("clock.json")
        if isinstance(clock, dict) and "unix_ns" in clock:
            self.clock_unix_ns = int(clock["unix_ns"])
        tr = os.path.join(self.path, "trace.jsonl")
        if os.path.exists(tr):
            try:
                self.trace_events = load_trace(tr)
            except (OSError, ValueError) as e:
                self.errors.append(f"trace.jsonl: {e}")
        fl = os.path.join(self.path, "flight.jsonl")
        if os.path.exists(fl):
            self.flight = self._read_jsonl(fl)
        metrics = self._read_json("metrics.json")
        if isinstance(metrics, dict):
            self.metrics = metrics
        # the black box carries a metrics snapshot too: preferred only
        # when it is the newer file (after a completed or quiesced run),
        # never a stale one from an earlier abort of a resumed run
        bb = self._read_json("blackbox.json")
        if isinstance(bb, dict) and isinstance(bb.get("metrics"), dict) \
                and bb["metrics"] and (not self.metrics or self._mtime(
                    "blackbox.json") >= self._mtime("metrics.json")):
            self.metrics = bb["metrics"]
        if not self.flight and isinstance(bb, dict):
            self.flight = [r for r in bb.get("records", [])
                           if isinstance(r, dict)]
        return self

    def _mtime(self, name: str) -> float:
        try:
            return os.path.getmtime(os.path.join(self.path, name))
        except OSError:
            return 0.0

    def _read_json(self, name: str) -> Any:
        try:
            with open(os.path.join(self.path, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _read_jsonl(self, path: str) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError as e:
            self.errors.append(f"{os.path.basename(path)}: {e}")
            return out
        for i, ln in enumerate(lines):
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
                if isinstance(rec, dict):
                    out.append(rec)
            except ValueError:
                if i == len(lines) - 1:
                    continue  # a torn last line: the SIGKILL signature
                self.errors.append(
                    f"{os.path.basename(path)}: bad record at line {i + 1}")
        return out


def load_obs_dir(path: str, rank: int = 0,
                 title: Optional[str] = None) -> RankObs:
    """One observability directory outside the ``rank<k>`` naming (the
    same files, parsed as leniently), such as a server's ``obs/server``;
    ``rank`` becomes its Chrome ``pid``."""
    return RankObs(rank, path, title).load()


def collect(run_dir: str) -> List[RankObs]:
    """Every ``rank<k>`` directory under ``run_dir/obs``, loaded, and
    every ``replica<k>/obs/server`` sink of a fleet run directory as a
    rank-shaped member titled ``replica<k>``, in rank order."""
    ranks: List[RankObs] = []
    obs = os.path.join(run_dir, "obs")
    try:
        names = sorted(os.listdir(obs))
    except OSError:
        names = []
    for name in names:
        m = _RANK_RE.match(name)
        sub = os.path.join(obs, name)
        if m and os.path.isdir(sub):
            ranks.append(RankObs(int(m.group(1)), sub).load())
    try:
        top = sorted(os.listdir(run_dir))
    except OSError:
        top = []
    # replicas come after the training ranks, so pids never collide
    base = max((r.rank for r in ranks), default=-1) + 1
    for name in top:
        m = _REPLICA_RE.match(name)
        sub = os.path.join(run_dir, name, "obs", "server")
        if m and os.path.isdir(sub):
            ranks.append(RankObs(base + int(m.group(1)), sub,
                                 title=name).load())
    return sorted(ranks, key=lambda r: r.rank)


# ---------------------------------------------------------------------------
# merged trace
# ---------------------------------------------------------------------------

def merge_trace(ranks: List[RankObs]) -> List[Dict[str, Any]]:
    """One clock-aligned event list: the earliest recorded clock base is
    the wall-clock anchor of t = 0; each rank's events shift by its offset
    from it and take the rank as ``pid``. Flight events become Chrome
    instants (phase 'i', process scope), so membership and elastic
    transitions show even for a rank whose trace ring never flushed. The
    lane names are the JAX package's (``xgboost_tpu rank <k>``), so both
    packages merge a run directory into the same file."""
    bases = [r.clock_unix_ns for r in ranks if r.clock_unix_ns is not None]
    anchor_ns = min(bases) if bases else 0
    merged: List[Dict[str, Any]] = []
    for r in ranks:
        merged.append({
            "name": "process_name", "ph": "M", "pid": r.rank, "tid": 0,
            "args": {"name": f"xgboost_tpu {r.title}"},
        })
        shift_us = 0
        if r.clock_unix_ns is not None and anchor_ns:
            shift_us = (r.clock_unix_ns - anchor_ns) // 1000
        for ev in r.trace_events:
            if ev.get("ph") == "M":
                continue  # regenerated above with the base rank as pid
            ev = dict(ev)
            ev["pid"] = r.rank
            if "ts" in ev:
                ev["ts"] = int(ev["ts"]) + shift_us
            merged.append(ev)
        for rec in r.flight:
            if rec.get("t") != "event" or "unix_ms" not in rec:
                continue
            ts = int(rec["unix_ms"] * 1000) - anchor_ns // 1000
            merged.append({
                "name": rec.get("name", "event"), "ph": "i", "s": "p",
                "ts": max(ts, 0), "pid": r.rank, "tid": 0,
                "args": rec.get("args", {}),
            })
    return merged


def write_trace(path: str, events: List[Dict[str, Any]]) -> None:
    """The trailing-comma array-of-lines form ``trace.flush`` writes
    (loadable in Perfetto, parseable line by line)."""
    with open(path, "w") as f:
        f.write("[\n")
        for ev in events:
            f.write(json.dumps(ev) + ",\n")


# ---------------------------------------------------------------------------
# metrics rollup
# ---------------------------------------------------------------------------

def rollup_metrics(ranks: List[RankObs]) -> Dict[str, Any]:
    """The registry across ranks: counters and histogram sums, counts and
    buckets add (the work done); gauges take the maximum (watermarks and
    state codes: a mean would describe no rank at all)."""
    out: Dict[str, Any] = {}
    for r in ranks:
        for name, fam in (r.metrics or {}).items():
            if not isinstance(fam, dict) or "series" not in fam:
                continue
            dst = out.setdefault(name, {
                "type": fam.get("type", "gauge"),
                "help": fam.get("help", ""),
                "series": {},
            })
            for s in fam["series"]:
                key = tuple(sorted((s.get("labels") or {}).items()))
                if dst["type"] == "histogram":
                    agg = dst["series"].setdefault(key, {
                        "labels": dict(key), "sum": 0.0, "count": 0,
                        "buckets": defaultdict(int), "ranks": 0,
                    })
                    agg["sum"] += float(s.get("sum", 0.0))
                    agg["count"] += int(s.get("count", 0))
                    for ub, c in (s.get("buckets") or {}).items():
                        agg["buckets"][ub] += int(c)
                    agg["ranks"] += 1
                else:
                    agg = dst["series"].setdefault(key, {
                        "labels": dict(key), "value": 0.0, "ranks": 0,
                    })
                    v = float(s.get("value", 0.0))
                    if dst["type"] == "counter":
                        agg["value"] += v
                    else:
                        agg["value"] = v if agg["ranks"] == 0 \
                            else max(agg["value"], v)
                    agg["ranks"] += 1
    for fam in out.values():
        series = []
        for _, agg in sorted(fam["series"].items()):
            if "buckets" in agg:
                agg["buckets"] = dict(agg["buckets"])
                # per-rank quantiles do not merge: recomputed from the
                # summed cumulative buckets
                agg["p50"] = _merged_quantile(agg["buckets"],
                                              agg["count"], 0.50)
                agg["p99"] = _merged_quantile(agg["buckets"],
                                              agg["count"], 0.99)
            series.append(agg)
        fam["series"] = series
    return out


def _merged_quantile(buckets: Dict[str, Any], count: int,
                     q: float) -> Optional[float]:
    """A Prometheus-style quantile from summed cumulative bucket counts
    (``metrics.Histogram.quantile``; snapshot buckets are cumulative and
    exclude +Inf, so ranks above the top bound clamp to the largest finite
    bound). None on an empty or unparsable series."""
    if not count or not buckets:
        return None
    try:
        ladder = sorted((float(ub), int(c)) for ub, c in buckets.items())
    except (TypeError, ValueError):
        return None
    target = max(min(float(q), 1.0), 0.0) * count
    lo, prev_cum = 0.0, 0
    for ub, cum in ladder:
        c = cum - prev_cum
        if c and cum >= target:
            frac = (target - prev_cum) / c
            return lo + (ub - lo) * min(max(frac, 0.0), 1.0)
        prev_cum, lo = cum, ub
    return ladder[-1][0]


# ---------------------------------------------------------------------------
# per-round fleet table
# ---------------------------------------------------------------------------

def fleet_table(ranks: List[RankObs]) -> Dict[str, Any]:
    """Round-by-round wall times across ranks, keyed (generation, round):
    ``per_round[(g, i)] = {rank: wall_s}``. ``replayed`` counts the
    repeats of a round index by one rank (the rounds elastic recovery
    trained again). A round's ``skew`` is the max - min wall seconds over
    the ranks that recorded it."""
    per_round: Dict[Tuple[int, int], Dict[int, float]] = defaultdict(dict)
    replayed = 0
    for r in ranks:
        seen: set = set()
        for rec in r.flight:
            if rec.get("t") != "round" or "wall_s" not in rec:
                continue
            base = int(rec.get("round", -1))
            n = max(int(rec.get("rounds", 1)), 1)
            gen = int(rec.get("gen", 0))
            for i in range(base, base + n):
                if i in seen:
                    replayed += 1
                seen.add(i)
                # a record of several rounds spreads its wall evenly
                per_round[(gen, i)][r.rank] = rec["wall_s"] / n
    rows = []
    for (gen, i), by_rank in sorted(per_round.items()):
        walls = list(by_rank.values())
        rows.append({
            "gen": gen, "round": i,
            "ranks": {str(k): round(v, 6) for k, v in sorted(
                by_rank.items())},
            "skew_s": round(max(walls) - min(walls), 6),
        })
    return {"rounds": rows, "replayed_rounds": replayed}


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) \
        + "}"


def format_fleet_report(ranks: List[RankObs], rollup: Dict[str, Any],
                        table: Dict[str, Any], top_rounds: int = 10) -> str:
    lines = [f"obs-report: {len(ranks)} rank(s)"]
    for r in ranks:
        n_rounds = sum(1 for rec in r.flight if rec.get("t") == "round")
        n_events = sum(1 for rec in r.flight if rec.get("t") == "event")
        lines.append(
            f"  {r.title}: {n_rounds} round records, {n_events} "
            f"events, {len(r.trace_events)} trace events"
            + (f", {len(r.errors)} parse errors" if r.errors else ""))
        for err in r.errors:
            lines.append(f"    ! {err}")
    events: Dict[str, int] = defaultdict(int)
    for r in ranks:
        for rec in r.flight:
            if rec.get("t") == "event":
                events[rec.get("name", "?")] += 1
    if events:
        lines.append("")
        lines.append("fleet events:")
        for name in sorted(events):
            lines.append(f"  {name}: {events[name]}")
    rows = table["rounds"]
    if rows:
        lines.append("")
        multi = any(len(row["ranks"]) > 1 for row in rows)
        total = sum(sum(row["ranks"].values()) for row in rows)
        lines.append(
            f"per-round fleet table: {len(rows)} (gen, round) entries, "
            f"{table['replayed_rounds']} replayed, "
            f"{total:.3f}s total round wall")
        show = sorted(rows, key=lambda r: -r["skew_s"])[:top_rounds] \
            if multi else rows[:top_rounds]
        lines.append(f"  {'gen':>4} {'round':>6} {'skew':>10}  per-rank s")
        for row in sorted(show, key=lambda r: (r["gen"], r["round"])):
            per = " ".join(f"r{k}={v:.3f}"
                           for k, v in row["ranks"].items())
            lines.append(f"  {row['gen']:>4} {row['round']:>6} "
                         f"{row['skew_s'] * 1e3:>8.2f}ms  {per}")
        if len(rows) > len(show):
            lines.append(f"  ... ({len(rows) - len(show)} more; "
                         "full table in metrics_rollup.json's sidecar)")
    counters = []
    for name, fam in sorted(rollup.items()):
        if fam["type"] != "counter":
            continue
        for s in fam["series"]:
            counters.append((name + _fmt_labels(s["labels"]), s["value"],
                             s["ranks"]))
    if counters:
        lines.append("")
        lines.append("metrics rollup (counters summed across ranks):")
        for name, value, nr in counters:
            lines.append(f"  {name} = {value:g}  [{nr} rank(s)]")
    for name, fam in sorted(rollup.items()):
        if fam["type"] != "histogram":
            continue
        for s in fam["series"]:
            if s["count"]:
                p99 = s.get("p99")
                lines.append(
                    f"  {name}{_fmt_labels(s['labels'])}: count={s['count']} "
                    f"mean={s['sum'] / s['count'] * 1e3:.3f}ms"
                    + (f" p99={p99 * 1e3:.3f}ms" if p99 is not None else ""))
    return "\n".join(lines)


def main(argv: List[str]) -> int:
    usage = ("usage: python -m xgboost_tpu_torch obs-report <run_dir> ... "
             "[--top-rounds N]")
    if not argv or argv[0] in ("-h", "--help"):
        print(usage, file=sys.stderr)
        return 0 if argv else 1
    top_rounds = 10
    if "--top-rounds" in argv:
        i = argv.index("--top-rounds")
        try:
            top_rounds = int(argv[i + 1])
        except (IndexError, ValueError):
            print(usage, file=sys.stderr)
            return 1
        argv = argv[:i] + argv[i + 2:]
    # several run_dirs merge into one report: each dir's ranks keep their
    # own pid block (dir index * 100 + rank) and carry the dir's name in
    # their lane title; the outputs land under the first dir
    run_dirs = argv
    run_dir = run_dirs[0]
    ranks: List[RankObs] = []
    for i, d in enumerate(run_dirs):
        sub = collect(d)
        for r in sub:
            if len(run_dirs) > 1:
                label = os.path.basename(os.path.normpath(d)) or d
                r.title = f"{label} {r.title}"
                r.rank += i * 100
        ranks.extend(sub)
    if not ranks:
        print(f"{' '.join(run_dirs)}: no obs/rank<k> (or replica<k>/obs/"
              "server) directories found (was the run given a "
              "flight-recorder sink? observability.flight.configure("
              "run_dir))", file=sys.stderr)
        return 1
    merged = merge_trace(ranks)
    rollup = rollup_metrics(ranks)
    table = fleet_table(ranks)
    obs = os.path.join(run_dir, "obs")
    trace_out = os.path.join(obs, "merged.trace.json")
    rollup_out = os.path.join(obs, "metrics_rollup.json")
    try:
        os.makedirs(obs, exist_ok=True)  # a fleet run_dir may have none
        write_trace(trace_out, merged)
        with open(rollup_out, "w") as f:
            json.dump({"rollup": rollup, "fleet_table": table}, f)
    except OSError as e:
        print(f"obs-report: cannot write outputs: {e}", file=sys.stderr)
        return 1
    print(format_fleet_report(ranks, rollup, table, top_rounds=top_rounds))
    print(f"\nmerged trace -> {trace_out} ({len(merged)} events)")
    print(f"metrics rollup -> {rollup_out}")
    return 0

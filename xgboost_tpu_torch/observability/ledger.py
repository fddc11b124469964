"""Banked perf ledger: every ``BENCH_r*.json`` as ONE trajectory (the port
of the JAX package's ``observability/ledger.py``, whole, with its schema).

A bench run is banked as ``BENCH_rNN.json`` at the repository root. The
older banks are hand-copied subprocess captures (``{"n", "cmd", "rc",
"tail", "parsed"}`` with the predict line buried in ``tail`` text; r01
banked a failed run as ``parsed: null``); ``write_bank`` writes the
canonical schema (``{"n", "schema", "cmd", "rc", "lines": [...]}``, first
line = the train record with stages + dispatch table, optional second
line = the predict record), the one the JAX package's ``bench.py --bank``
writes, so either package reads the other's banks. This module reads BOTH
formats into one trajectory keyed by **(metric family, workload shape)**
so ``python -m xgboost_tpu_torch perf-report`` can render the whole perf
history — rounds/s, stage splits, vs_baseline, delta vs the banked best —
and tolerate gaps (rounds that banked nothing, e.g. r06–r14) without
guessing. Standard library only.

Metric-name grammar (produced by bench.py)::

    train_time_{rows//1000}kx{cols}_{iters}r_depth{d}[_bin{b}][_markers]
    predict_inplace_100kx50_10r

with markers ``_cpu_fallback`` / ``_extrapolated_from_{n}r`` /
``_quality_failed`` / ``_parity_failed`` parsed OFF the shape key and
kept as annotations — a degraded run lands on the same trajectory row
it degraded from, flagged, instead of forking a phantom workload.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SCHEMA", "parse_metric", "validate_record", "load_bank_file",
    "load_ledger", "trajectory", "write_bank", "format_report", "main",
]

SCHEMA = "bench-bank-v1"

_BANK_GLOB = "BENCH_r[0-9]*.json"
_BANK_RE = re.compile(r"BENCH_r(\d+)\.json$")

#: boolean degradation markers bench.py appends to the metric name
_MARKERS = ("cpu_fallback", "quality_failed", "parity_failed")

_EXTRAP_RE = re.compile(r"_extrapolated_from_(\d+)r")
_SHAPE_RE = re.compile(
    r"^(?P<family>[a-z][a-z_]*?)_(?P<kr>\d+)kx(?P<cols>\d+)(?P<rest>(?:_.*)?)$")


# ---------------------------------------------------------------------------
# metric-name grammar
# ---------------------------------------------------------------------------


def parse_metric(name: str) -> Optional[Dict[str, Any]]:
    """Parse a bench metric name; ``None`` when it doesn't follow the
    grammar (e.g. ``train_time_failed``)."""
    if not isinstance(name, str):
        return None
    markers: List[str] = []
    stripped = name
    for mk in _MARKERS:
        if f"_{mk}" in stripped:
            markers.append(mk)
            stripped = stripped.replace(f"_{mk}", "")
    m = _EXTRAP_RE.search(stripped)
    measured_rounds = None
    if m:
        measured_rounds = int(m.group(1))
        markers.append(f"extrapolated_from_{measured_rounds}r")
        stripped = stripped[:m.start()] + stripped[m.end():]
    m = _SHAPE_RE.match(stripped)
    if not m:
        return None
    rest = m.group("rest")
    rounds = None
    rm = re.search(r"_(\d+)r(?:_|$)", rest)
    if rm:
        rounds = int(rm.group(1))
    dm = re.search(r"_depth(\d+)", rest)
    bm = re.search(r"_bin(\d+)", rest)
    return {
        "metric": name,
        "family": m.group("family"),
        "shape": f"{m.group('kr')}kx{m.group('cols')}",
        "rows": int(m.group("kr")) * 1000,
        "cols": int(m.group("cols")),
        "rounds": rounds,
        "depth": int(dm.group(1)) if dm else None,
        "bin": int(bm.group(1)) if bm else None,
        "markers": markers,
        "measured_rounds": measured_rounds,
    }


# ---------------------------------------------------------------------------
# record validation (the --bank write path refuses bad records)
# ---------------------------------------------------------------------------


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def validate_record(rec: Any, require_stages: bool = False) -> List[str]:
    """Schema check for one bench JSON line; returns the (possibly
    empty) list of violations. ``require_stages`` is the contract for
    the PRIMARY train line: stage split + dispatch table must be there,
    or the banked round is useless for attribution."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return ["record is not an object"]
    metric = rec.get("metric")
    if parse_metric(metric) is None:
        errs.append(f"metric {metric!r} does not follow the bench grammar")
    if not _num(rec.get("value")) or rec.get("value", -1) < 0:
        errs.append(f"value {rec.get('value')!r} is not a finite number >= 0")
    if not isinstance(rec.get("unit"), str) or not rec.get("unit"):
        errs.append(f"unit {rec.get('unit')!r} is not a nonempty string")
    if "vs_baseline" in rec and not _num(rec["vs_baseline"]):
        errs.append(f"vs_baseline {rec['vs_baseline']!r} is not a number")
    if require_stages:
        stages = rec.get("stages")
        if not isinstance(stages, dict) or not stages or not all(
                isinstance(k, str) and _num(v) for k, v in stages.items()):
            errs.append("stages must be a nonempty {stage: seconds} object")
        disp = rec.get("dispatch")
        if not isinstance(disp, dict) or not disp or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in disp.items()):
            errs.append("dispatch must be a nonempty {op: impl} object")
        if "vs_baseline" not in rec:
            errs.append("train line must carry vs_baseline")
    return errs


# ---------------------------------------------------------------------------
# bank IO (old + new formats)
# ---------------------------------------------------------------------------


def load_bank_file(path: str) -> Dict[str, Any]:
    """One banked round -> ``{"n", "rc", "cmd", "records": [...]}``.
    Old-format files recover the predict line from the raw ``tail`` text
    (it was never in ``parsed``); a failed bank (r01: rc=1,
    parsed=null) loads as zero records rather than raising."""
    with open(path) as f:
        doc = json.load(f)
    n = doc.get("n")
    if not isinstance(n, int):
        m = _BANK_RE.search(os.path.basename(path))
        n = int(m.group(1)) if m else -1
    records: List[Dict[str, Any]] = []

    def add(rec: Any) -> None:
        if isinstance(rec, dict) and isinstance(rec.get("metric"), str) \
                and not any(r.get("metric") == rec["metric"]
                            for r in records):
            records.append(rec)

    if isinstance(doc.get("lines"), list):  # canonical (bench --bank)
        for rec in doc["lines"]:
            add(rec)
    else:  # legacy hand-copied capture
        add(doc.get("parsed"))
        for line in str(doc.get("tail") or "").splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    add(json.loads(line))
                except ValueError:
                    continue
    return {"n": n, "rc": doc.get("rc"), "cmd": doc.get("cmd", ""),
            "path": path, "records": records}


def load_ledger(root: str = ".") -> List[Dict[str, Any]]:
    """Every readable ``BENCH_r*.json`` under ``root``, sorted by round
    number. Unreadable files are reported on stderr and skipped — one
    torn bank must not hide the rest of the trajectory."""
    out: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(root, _BANK_GLOB))):
        try:
            out.append(load_bank_file(path))
        except (OSError, ValueError) as e:
            print(f"{path}: unreadable bank: {e}", file=sys.stderr)
    out.sort(key=lambda d: d["n"])
    return out


def write_bank(root: str, n: int, cmd: str, rc: int,
               records: List[Dict[str, Any]]) -> str:
    """Write the canonical ``BENCH_rNN.json`` (atomic replace). The
    primary (train) record is schema-validated WITH stages + dispatch;
    any further lines (predict) get the base check. Raises ValueError
    with every violation listed — a malformed bank is worse than none."""
    if not records:
        raise ValueError("nothing to bank: no bench records")
    errs = [f"line 0: {e}"
            for e in validate_record(records[0], require_stages=True)]
    for i, rec in enumerate(records[1:], start=1):
        errs += [f"line {i}: {e}" for e in validate_record(rec)]
    if errs:
        raise ValueError("; ".join(errs))
    doc = {"n": int(n), "schema": SCHEMA, "cmd": cmd, "rc": int(rc),
           "lines": records, "parsed": records[0]}
    path = os.path.join(root, f"BENCH_r{int(n):02d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# the trajectory
# ---------------------------------------------------------------------------


def trajectory(banks: List[Dict[str, Any]]) -> Dict[Tuple[str, str],
                                                    List[Dict[str, Any]]]:
    """(family, shape) -> points sorted by round number. Each point
    carries the parsed metric facts plus rounds/s when derivable
    (train-family seconds with a round count)."""
    groups: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for bank in banks:
        for rec in bank["records"]:
            facts = parse_metric(rec.get("metric"))
            if facts is None or not _num(rec.get("value")):
                continue
            pt = dict(facts)
            pt.update({
                "n": bank["n"],
                "value": float(rec["value"]),
                "unit": rec.get("unit", ""),
                "vs_baseline": rec.get("vs_baseline"),
                "stages": rec.get("stages"),
                "dispatch": rec.get("dispatch"),
            })
            if facts["family"] == "train_time" and facts["rounds"] \
                    and rec.get("unit") == "s" and rec["value"] > 0:
                pt["rounds_per_s"] = round(facts["rounds"] / rec["value"], 3)
            groups.setdefault((facts["family"], facts["shape"]),
                              []).append(pt)
    for pts in groups.values():
        pts.sort(key=lambda p: p["n"])
    return groups


def _gaps(banked: List[int]) -> str:
    """Human-readable missing-round ranges between the first and last
    banked round (the r06–r14 gap prints instead of surprising)."""
    if len(banked) < 2:
        return ""
    have = set(banked)
    missing: List[str] = []
    lo = None
    for n in range(min(banked), max(banked) + 1):
        if n in have:
            if lo is not None:
                hi = n - 1
                missing.append(f"r{lo:02d}" if lo == hi
                               else f"r{lo:02d}-r{hi:02d}")
                lo = None
        elif lo is None:
            lo = n
    return ", ".join(missing)


def _best(pts: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    clean = [p for p in pts
             if "rounds_per_s" in p
             and not any(mk in p["markers"]
                         for mk in ("quality_failed", "parity_failed"))]
    return max(clean, key=lambda p: p["rounds_per_s"]) if clean else None


def format_report(banks: List[Dict[str, Any]],
                  published: Optional[Dict[str, Any]] = None) -> str:
    banked = [b["n"] for b in banks]
    failed = [b["n"] for b in banks if not b["records"]]
    lines = [
        f"== perf ledger: {len(banks)} banked rounds "
        f"({', '.join(f'r{n:02d}' for n in banked)}) =="
    ]
    gaps = _gaps(banked)
    if gaps:
        lines.append(f"   unbanked rounds (no BENCH file): {gaps}")
    if failed:
        lines.append("   failed banks (rc!=0, no parsed record): "
                     + ", ".join(f"r{n:02d}" for n in failed))
    for (family, shape), pts in sorted(trajectory(banks).items()):
        lines.append("")
        lines.append(f"{family} @ {shape}:")
        best = _best(pts)
        for p in pts:
            cfg = "_".join(
                s for s in (f"{p['rounds']}r" if p["rounds"] else "",
                            f"depth{p['depth']}" if p["depth"] else "",
                            f"bin{p['bin']}" if p["bin"] else "") if s)
            row = (f"  r{p['n']:02d}  {p['value']:>10.2f}{p['unit']:<7}"
                   f" {cfg:<22}")
            if "rounds_per_s" in p:
                row += f" {p['rounds_per_s']:>8.3f} r/s"
                if best is not None and best["rounds_per_s"] > 0:
                    delta = (p["rounds_per_s"] / best["rounds_per_s"]
                             - 1.0) * 100.0
                    row += ("   best" if p is best
                            else f" {delta:>+6.1f}% vs best r{best['n']:02d}")
            if _num(p.get("vs_baseline")) and p["vs_baseline"] > 0:
                row += f"   vs_baseline {p['vs_baseline']:.3f}x"
            if p["markers"]:
                row += "   [" + ",".join(p["markers"]) + "]"
            lines.append(row)
            stages = p.get("stages")
            if isinstance(stages, dict) and stages:
                split = ", ".join(
                    f"{k} {v:.2f}s" for k, v in sorted(
                        stages.items(), key=lambda kv: -kv[1]))
                lines.append(f"        stages: {split}")
            disp = p.get("dispatch")
            if isinstance(disp, dict) and disp:
                lines.append("        dispatch: " + ",".join(
                    f"{op}={impl}" for op, impl in sorted(disp.items())))
    if published:
        lines.append("")
        lines.append("published reference anchors (BASELINE.json):")
        for key, ref in sorted(published.items()):
            if isinstance(ref, dict):
                desc = ", ".join(f"{k}={v}" for k, v in sorted(ref.items()))
            else:
                desc = str(ref)
            lines.append(f"  {key}: {desc}")
    return "\n".join(lines)


def main(argv: List[str]) -> int:
    usage = ("usage: python -m xgboost_tpu_torch perf-report [--root DIR] "
             "[--json]")
    root = "."
    as_json = False
    argv = list(argv)
    if "-h" in argv or "--help" in argv:
        print(usage, file=sys.stderr)
        return 0
    if "--json" in argv:
        as_json = True
        argv.remove("--json")
    if "--root" in argv:
        i = argv.index("--root")
        try:
            root = argv[i + 1]
        except IndexError:
            print(usage, file=sys.stderr)
            return 1
        argv = argv[:i] + argv[i + 2:]
    if argv:
        print(usage, file=sys.stderr)
        return 1
    banks = load_ledger(root)
    if not banks:
        print(f"no {_BANK_GLOB} files under {root!r}", file=sys.stderr)
        return 1
    published = None
    try:
        with open(os.path.join(root, "BASELINE.json")) as f:
            published = json.load(f).get("published") or None
    except (OSError, ValueError):
        pass
    if as_json:
        traj = {f"{fam}@{shape}": pts for (fam, shape), pts
                in trajectory(banks).items()}
        print(json.dumps({"banked": [b["n"] for b in banks],
                          "trajectory": traj}, indent=1))
    else:
        print(format_report(banks, published))
    return 0

"""The serving report: ``python -m xgboost_tpu_torch serve-report <dir>``
(the port of the JAX package's ``observability/serve_report.py``, whose
outputs it writes for the same directories).

The sibling of ``obs-report`` for the traffic-facing half. A
:class:`~xgboost_tpu_torch.serving.ModelServer` given a ``run_dir`` (or
``XGBTPU_SERVE_DIR``) keeps its request-scope observability under
``run_dir/obs/server/``: ``access.jsonl`` (one line per request),
``flight.jsonl`` (the per-dispatch ring and timeline events),
``trace.jsonl`` (per-request span tracks), ``metrics.json`` and
``clock.json``. This module merges them into one page:

- **latency percentiles per model**: p50 / p99 / max of a request's total
  time, queue-wait and dispatch p99, exact from the access log;
- **shed timeline**: per-second counts of ok / shed (by reason) / error,
  with model load / swap / evict events where they happened; its
  ``native`` column counts the JAX package's native-walker dispatches and
  reads 0 on the port's records (the port never routes ``native``);
- **coalescing**: requests per dispatch and the route mix from the
  dispatch ring (``kernel`` is kernel B on the card); ``cache_misses``
  sums the JAX package's program-cache misses and reads 0 on the port's
  records, which have no program cache;
- **worst-request exemplars**: the slowest requests with their stages
  (queue -> batch wait -> dispatch);
- **merged Chrome trace**: ``obs/serve.trace.json``, spans and timeline
  events clock-aligned by ``fleet.merge_trace``, as a training rank's.

A fleet run directory (``serve-fleet``: ``replica<k>/obs/server``) gives
one fleet-wide report with per-replica and per-tenant rollups,
``obs/fleet_serve_report.json`` and ``obs/fleet_serve.trace.json``; a
single server gives ``obs/serve_report.json``. Either package's server
directories are read alike. Partial data is expected (a killed server's
last line may be torn); a directory with no serving observability exits
1.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from . import fleet

__all__ = ["load_server_obs", "summarize_access", "summarize_tenants",
           "summarize_delivery", "format_serve_report",
           "expand_server_dirs", "main"]

#: timeline events emitted by the train-to-serve delivery loop
#: (serving/delivery.py + the server's publish/promote/rollback/
#: quarantine methods) — rendered as their own report section
_DELIVERY_EVENTS = (
    "checkpoint_seen", "checkpoint_skipped", "model_published",
    "canary_start", "canary_rejected", "model_promoted",
    "model_rolled_back", "model_quarantined", "model_discarded")


def _resolve_dir(path: str) -> Optional[str]:
    """The ``obs/server`` directory for any of: a server run_dir, its
    ``obs`` directory, or the server directory itself."""
    for cand in (os.path.join(path, "obs", "server"),
                 os.path.join(path, "server"), path):
        if os.path.isfile(os.path.join(cand, "access.jsonl")) \
                or os.path.isfile(os.path.join(cand, "flight.jsonl")):
            return cand
    return None


def expand_server_dirs(paths: List[str]) -> List[Tuple[str, str]]:
    """(label, server-obs dir) for every serving sink named by ``paths``:
    each path may be a single server run_dir (label = its basename) OR a
    fleet run_dir whose ``replica<k>/`` children each hold one
    (labels ``replica<k>``) — the ``serve-fleet`` layout."""
    entries: List[Tuple[str, str]] = []
    for p in paths:
        d = _resolve_dir(p)
        if d is not None:
            entries.append(
                (os.path.basename(os.path.normpath(p)) or p, d))
            continue
        try:
            names = os.listdir(p)
        except OSError:
            continue
        matches = [(int(m.group(1)), name) for name, m in
                   ((n, fleet._REPLICA_RE.match(n)) for n in names) if m]
        for _, name in sorted(matches):  # numeric: replica2 < replica10
            sub = _resolve_dir(os.path.join(p, name))
            if sub is not None:
                entries.append((name, sub))
    return entries


def load_server_obs(path: str) -> Optional[Tuple[Any, List[Dict[str, Any]]]]:
    """(RankObs-view of the server dir, access records) or None when
    ``path`` holds no serving observability."""
    d = _resolve_dir(path)
    if d is None:
        return None
    obs = fleet.load_obs_dir(d, rank=0)
    access = [rec for rec in obs._read_jsonl(
        os.path.join(d, "access.jsonl")) if rec.get("t") == "req"]
    return obs, access


def _pct(sorted_vals: List[float], q: float) -> float:
    """Exact empirical quantile (nearest-rank) of pre-sorted values."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def summarize_access(access: List[Dict[str, Any]],
                     dispatches: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The machine-readable summary the text report renders."""
    outcomes: Dict[str, int] = defaultdict(int)
    shed_reasons: Dict[str, int] = defaultdict(int)
    per_model: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for rec in access:
        outcomes[rec.get("outcome", "?")] += 1
        if rec.get("shed"):
            shed_reasons[rec["shed"]] += 1
        per_model[rec.get("model", "?")].append(rec)
    models: Dict[str, Any] = {}
    for model, recs in sorted(per_model.items()):
        ok = [r for r in recs if r.get("outcome") == "ok"]
        totals = sorted(r.get("total_s", 0.0) for r in ok)
        queues = sorted(r["queue_wait_s"] for r in ok
                        if "queue_wait_s" in r)
        disp = sorted(r["dispatch_s"] for r in ok if "dispatch_s" in r)
        models[model] = {
            "requests": len(recs), "ok": len(ok),
            "rows": sum(int(r.get("rows", 0)) for r in recs),
            "total_p50_s": _pct(totals, 0.50),
            "total_p99_s": _pct(totals, 0.99),
            "total_max_s": totals[-1] if totals else 0.0,
            "queue_wait_p99_s": _pct(queues, 0.99),
            "dispatch_p99_s": _pct(disp, 0.99),
        }
    routes: Dict[str, int] = defaultdict(int)
    reqs = rows = misses = 0
    for d in dispatches:
        routes[d.get("route") or "?"] += 1
        reqs += int(d.get("reqs", 0))
        rows += int(d.get("rows", 0))
        misses += int(d.get("cache_misses", 0))
    return {
        "requests": len(access),
        "outcomes": dict(outcomes),
        "shed_reasons": dict(shed_reasons),
        "models": models,
        "dispatches": len(dispatches),
        "dispatched_rows": rows,
        "coalesce_ratio": reqs / max(len(dispatches), 1),
        "routes": dict(routes),
        "cache_misses": misses,
    }


def summarize_tenants(access: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per request-tenant rollup from access lines (requests that carried
    no tenant group under ``-``): counts, shed reasons, exact total-time
    and queue-wait percentiles; fleet-wide when the access set spans
    replicas."""
    per: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for rec in access:
        per[rec.get("tenant") or "-"].append(rec)
    out: Dict[str, Any] = {}
    for tenant, recs in sorted(per.items()):
        ok = [r for r in recs if r.get("outcome") == "ok"]
        totals = sorted(r.get("total_s", 0.0) for r in ok)
        queues = sorted(r["queue_wait_s"] for r in ok
                        if "queue_wait_s" in r)
        sheds: Dict[str, int] = defaultdict(int)
        for r in recs:
            if r.get("shed"):
                sheds[r["shed"]] += 1
        out[tenant] = {
            "requests": len(recs), "ok": len(ok),
            "rows": sum(int(r.get("rows", 0)) for r in ok),
            "total_p50_s": _pct(totals, 0.50),
            "total_p99_s": _pct(totals, 0.99),
            "queue_wait_p99_s": _pct(queues, 0.99),
            "shed_reasons": dict(sheds),
        }
    return out


def summarize_delivery(events: List[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
    """The delivery story in order: every checkpoint_seen / skipped /
    published / canary / promote / rollback / quarantine event with its
    args flattened: the report's "model delivery" section."""
    rows: List[Dict[str, Any]] = []
    for ev in events:
        if ev.get("name") not in _DELIVERY_EVENTS:
            continue
        args = ev.get("args") or {}
        row: Dict[str, Any] = {"unix_ms": ev.get("unix_ms"),
                               "event": ev["name"]}
        for k in sorted(args):
            row.setdefault(k, args[k])
        rows.append(row)
    rows.sort(key=lambda r: r.get("unix_ms") or 0)
    return rows


def _timeline(access: List[Dict[str, Any]],
              events: List[Dict[str, Any]],
              dispatches: List[Dict[str, Any]],
              bucket_s: float = 1.0) -> List[Dict[str, Any]]:
    """Per-``bucket_s`` activity rows: outcome counts, native-routed
    dispatches, and the events that fell in the bucket — the shed/
    degrade/swap story in order."""
    stamps = [r["unix_ms"] for r in access + events + dispatches
              if "unix_ms" in r]
    if not stamps:
        return []
    base = min(stamps)
    rows: Dict[int, Dict[str, Any]] = {}

    def at(ms: float) -> Dict[str, Any]:
        k = int((ms - base) / (bucket_s * 1e3))
        return rows.setdefault(k, {
            "t_s": k * bucket_s, "ok": 0, "shed": 0, "error": 0,
            "native": 0, "sheds": defaultdict(int), "events": []})

    for rec in access:
        if "unix_ms" not in rec:
            continue
        row = at(rec["unix_ms"])
        outcome = rec.get("outcome", "error")
        row[outcome if outcome in ("ok", "shed", "error") else "error"] += 1
        if rec.get("shed"):
            row["sheds"][rec["shed"]] += 1
    for d in dispatches:
        if d.get("route") == "native" and "unix_ms" in d:
            at(d["unix_ms"])["native"] += 1
    for ev in events:
        if "unix_ms" not in ev:
            continue
        label = ev.get("name", "event")
        model = (ev.get("args") or {}).get("model")
        at(ev["unix_ms"])["events"].append(
            f"{label}({model})" if model else label)
    out = []
    for k in sorted(rows):
        row = rows[k]
        row["sheds"] = dict(row["sheds"])
        out.append(row)
    return out


def format_serve_report(summary: Dict[str, Any],
                        timeline: List[Dict[str, Any]],
                        exemplars: List[Dict[str, Any]],
                        top: int = 8,
                        tenants: Optional[Dict[str, Any]] = None,
                        replicas: Optional[List[Dict[str, Any]]] = None,
                        delivery: Optional[List[Dict[str, Any]]] = None
                        ) -> str:
    o = summary["outcomes"]
    shed_detail = ",".join(f"{k}={v}" for k, v in
                           sorted(summary["shed_reasons"].items()))
    head = "serve-report" if not replicas \
        else f"fleet serve-report ({len(replicas)} replicas)"
    lines = [
        f"{head}: {summary['requests']} request(s) — "
        f"ok={o.get('ok', 0)} shed={o.get('shed', 0)}"
        + (f" ({shed_detail})" if shed_detail else "")
        + f" error={o.get('error', 0)}",
        f"dispatches: {summary['dispatches']} "
        f"({summary['dispatched_rows']} rows, coalescing "
        f"{summary['coalesce_ratio']:.2f} req/dispatch, "
        f"{summary['cache_misses']} program-cache misses); routes: "
        + (" ".join(f"{k}={v}" for k, v in
                    sorted(summary["routes"].items())) or "none"),
    ]
    if replicas:
        lines.append("")
        lines.append("per-replica rollup:")
        lines.append(f"  {'replica':<14} {'n':>6} {'ok':>6} {'shed':>5} "
                     f"{'err':>4} {'p50':>10} {'p99':>10} {'burn':>6}  "
                     "events")
        for r in replicas:
            evs = ",".join(f"{k}={v}" for k, v in
                           sorted(r.get("events", {}).items()))
            lines.append(
                f"  {r['replica']:<14} {r['requests']:>6} {r['ok']:>6} "
                f"{r['shed']:>5} {r['error']:>4} "
                f"{r['total_p50_s'] * 1e3:>8.2f}ms "
                f"{r['total_p99_s'] * 1e3:>8.2f}ms "
                f"{r.get('burn', 0.0):>6.2f}  {evs}")
    if summary["models"]:
        lines.append("")
        lines.append("per-model latency (access log, completed requests):")
        lines.append(f"  {'model':<18} {'n':>6} {'ok':>6} {'p50':>10} "
                     f"{'p99':>10} {'max':>10} {'queue p99':>10} "
                     f"{'disp p99':>10}")
        for model, m in summary["models"].items():
            lines.append(
                f"  {model:<18} {m['requests']:>6} {m['ok']:>6} "
                f"{m['total_p50_s'] * 1e3:>8.2f}ms "
                f"{m['total_p99_s'] * 1e3:>8.2f}ms "
                f"{m['total_max_s'] * 1e3:>8.2f}ms "
                f"{m['queue_wait_p99_s'] * 1e3:>8.2f}ms "
                f"{m['dispatch_p99_s'] * 1e3:>8.2f}ms")
    if tenants and (len(tenants) > 1 or "-" not in tenants):
        lines.append("")
        lines.append("per-tenant rollup (access log):")
        lines.append(f"  {'tenant':<14} {'n':>6} {'ok':>6} {'rows':>7} "
                     f"{'p50':>10} {'p99':>10} {'queue p99':>10}  sheds")
        for tenant, t in tenants.items():
            sheds = ",".join(f"{k}={v}" for k, v in
                             sorted(t["shed_reasons"].items()))
            lines.append(
                f"  {tenant:<14} {t['requests']:>6} {t['ok']:>6} "
                f"{t['rows']:>7} {t['total_p50_s'] * 1e3:>8.2f}ms "
                f"{t['total_p99_s'] * 1e3:>8.2f}ms "
                f"{t['queue_wait_p99_s'] * 1e3:>8.2f}ms  {sheds}")
    if delivery:
        lines.append("")
        lines.append("model delivery (train-to-serve loop):")
        base = next((r["unix_ms"] for r in delivery
                     if r.get("unix_ms") is not None), 0)
        for row in delivery:
            t = ((row.get("unix_ms") or base) - base) / 1e3
            detail = " ".join(
                f"{k}={v}" for k, v in row.items()
                if k not in ("unix_ms", "event") and v is not None)
            lines.append(f"  t+{t:>6.1f}s {row['event']:<20} {detail}")
    if timeline:
        lines.append("")
        lines.append("shed/degrade timeline (1s buckets):")
        for row in timeline:
            sheds = "".join(f" shed[{k}]={v}"
                            for k, v in sorted(row["sheds"].items()))
            evs = ("  | " + ", ".join(row["events"])) if row["events"] \
                else ""
            lines.append(
                f"  t+{row['t_s']:>4.0f}s ok={row['ok']:<5} "
                f"shed={row['shed']:<4} err={row['error']:<4} "
                f"native={row['native']:<4}{sheds}{evs}")
    if exemplars:
        lines.append("")
        lines.append(f"worst-request exemplars (top {min(top, len(exemplars))} "
                     "by total time):")
        lines.append(f"  {'id':<16} {'model':<14} {'rows':>5} {'total':>10} "
                     f"{'queue':>9} {'batch':>9} {'disp':>9}  outcome")
        for rec in exemplars[:top]:
            lines.append(
                f"  {str(rec.get('id', '?')):<16} "
                f"{rec.get('model', '?'):<14} {rec.get('rows', 0):>5} "
                f"{rec.get('total_s', 0) * 1e3:>8.2f}ms "
                f"{rec.get('queue_wait_s', 0) * 1e3:>7.2f}ms "
                f"{rec.get('batch_wait_s', 0) * 1e3:>7.2f}ms "
                f"{rec.get('dispatch_s', 0) * 1e3:>7.2f}ms  "
                f"{rec.get('outcome', '?')}"
                + (f" ({rec['shed']})" if rec.get("shed") else ""))
    return "\n".join(lines)


def _replica_burn(obs: Any) -> float:
    """The replica's last-persisted error-budget burn gauge (0.0 when the
    snapshot never landed)."""
    fam = (obs.metrics or {}).get("serving_error_budget_burn")
    if not isinstance(fam, dict):
        return 0.0
    for s in fam.get("series", []):
        if not s.get("labels"):
            return float(s.get("value", 0.0))
    return 0.0


def main(argv: List[str]) -> int:
    usage = ("usage: python -m xgboost_tpu_torch serve-report <dir> ... "
             "[--top N]  (a dir may be one server run_dir or a fleet "
             "run_dir with replica<k>/ children)")
    if not argv or argv[0] in ("-h", "--help"):
        print(usage, file=sys.stderr)
        return 0 if argv else 1
    top = 8
    if "--top" in argv:
        i = argv.index("--top")
        try:
            top = int(argv[i + 1])
        except (IndexError, ValueError):
            print(usage, file=sys.stderr)
            return 1
        argv = argv[:i] + argv[i + 2:]
    entries = expand_server_dirs(argv)
    if not entries:
        print(f"{' '.join(argv)}: no serving observability found (launch "
              "the server with run_dir= / --run-dir / XGBTPU_SERVE_DIR, "
              "or point at a serve-fleet run_dir)", file=sys.stderr)
        return 1
    fleet_mode = len(entries) > 1
    all_obs, access, replicas = [], [], []
    events: List[Dict[str, Any]] = []
    dispatches: List[Dict[str, Any]] = []
    for k, (label, d) in enumerate(entries):
        obs = fleet.load_obs_dir(d, rank=k, title=label)
        for err in obs.errors:
            print(f"serve-report: {label}: {err}", file=sys.stderr)
        acc = [rec for rec in obs._read_jsonl(
            os.path.join(d, "access.jsonl")) if rec.get("t") == "req"]
        evs = [r for r in obs.flight if r.get("t") == "event"]
        dis = [r for r in obs.flight if r.get("t") == "dispatch"]
        if fleet_mode:
            for rec in acc:
                rec["replica"] = label
            for rec in evs:
                rec.setdefault("args", {})["replica"] = label
            rsum = summarize_access(acc, dis)
            o = rsum["outcomes"]
            totals = sorted(r.get("total_s", 0.0) for r in acc
                            if r.get("outcome") == "ok")
            replicas.append({
                "replica": label, "requests": rsum["requests"],
                "ok": o.get("ok", 0), "shed": o.get("shed", 0),
                "error": o.get("error", 0),
                "total_p50_s": _pct(totals, 0.50),
                "total_p99_s": _pct(totals, 0.99),
                "shed_reasons": rsum["shed_reasons"],
                "burn": _replica_burn(obs),
                "events": {name: sum(1 for e in evs
                                     if e.get("name") == name)
                           for name in sorted({e.get("name", "?")
                                               for e in evs})},
            })
        all_obs.append(obs)
        access.extend(acc)
        events.extend(evs)
        dispatches.extend(dis)
    summary = summarize_access(access, dispatches)
    tenants = summarize_tenants(access)
    timeline = _timeline(access, events, dispatches)
    delivery = summarize_delivery(events)
    exemplars = sorted((r for r in access if "total_s" in r),
                       key=lambda r: -r["total_s"])
    print(format_serve_report(summary, timeline, exemplars, top=top,
                              tenants=tenants,
                              replicas=replicas if fleet_mode else None,
                              delivery=delivery))

    if fleet_mode:
        # one fleet-wide artifact set under the FIRST input's obs/ dir
        obs_dir = os.path.join(argv[0], "obs")
        try:
            os.makedirs(obs_dir, exist_ok=True)
        except OSError:
            obs_dir = os.path.dirname(all_obs[0].path)
        trace_out = os.path.join(obs_dir, "fleet_serve.trace.json")
        report_out = os.path.join(obs_dir, "fleet_serve_report.json")
        doc = {"summary": summary, "replicas": replicas,
               "tenants": tenants, "timeline": timeline,
               "delivery": delivery,
               "exemplars": exemplars[:top],
               "rollup": fleet.rollup_metrics(all_obs)}
    else:
        obs_dir = os.path.dirname(all_obs[0].path)
        trace_out = os.path.join(obs_dir, "serve.trace.json")
        report_out = os.path.join(obs_dir, "serve_report.json")
        doc = {"summary": summary, "tenants": tenants,
               "timeline": timeline, "delivery": delivery,
               "exemplars": exemplars[:top]}
    try:
        fleet.write_trace(trace_out, fleet.merge_trace(all_obs))
        with open(report_out, "w") as f:
            json.dump(doc, f, default=str)
    except OSError as e:
        print(f"serve-report: cannot write outputs: {e}", file=sys.stderr)
        return 1
    n_spans = sum(len(o.trace_events) for o in all_obs)
    print(f"\nmerged trace -> {trace_out} ({n_spans} span events)")
    print(f"summary -> {report_out}")
    return 0

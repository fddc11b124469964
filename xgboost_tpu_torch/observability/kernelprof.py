"""Per-level grow profiler: per-depth × per-op attribution on demand (the
port of the JAX package's ``observability/kernelprof.py``).

The flight recorder can say a round spent most of its wall in ``grow`` —
and nothing more. This module splits that time. On **sampled rounds only**
(``XGBTPU_KERNEL_PROF=every=N`` or ``rounds=a,b,c``; off by default, and a
malformed spec means off), ``train`` arms a profile on its thread and the
depthwise grower (``tree/grow_fused.py``) runs its one level loop through
a bracketing step seam, which closes each op with a completion sync
(``torch.cuda.synchronize``) and produces a per-round ``grow_detail``
record, field for field the JAX package's:

- per-depth × per-op wall time (``prep`` / ``level_hist`` /
  ``level_update`` / ``level_partition`` / ``finalize`` / ``leaf_delta``)
  with the impl that ran: ``cuda:D`` or ``cuda:A`` for a level histogram
  on the card (kernel D, ``hoisted_level``, or kernel A, ``fused_level``,
  read from their launch counts across the bracket), ``torch`` for the
  other ops there, ``plain`` for every op on the CPU;
- a **host-blocked vs in-flight** split per bucket: time until the call
  returned to the host (the Python that issues the launches) vs time until
  the card had finished them;
- the **inter-op gap** (host time between one op's completion and the next
  op's start);
- ``host_syncs_total{site=op}`` — every deliberate completion sync,
  counted at the seam (the series is created at the first sampled round,
  so an unprofiled run's exposition has no trace of it).

The port's production level loop is already driven from the host, one
level at a time, so there is no mirror: a sampled round runs the same loop
with the same calls in the same order, and only the syncs are added, so
its trees are bit for bit the unsampled round's by construction. Round 0
builds kernel C's one-hot before the grow and each round's eval walk
(kernel B) runs after it: both fall outside every grow bracket (they are
``round_detail``'s ``onehot`` and ``eval_walk``, below).

Rounds this profiler does not cover leave the armed profile empty and
``disarm()`` returns None, as the JAX package's scan, paged and mesh
rounds do: paged matrices (``grow_tree_fused_paged``), a row ``group``,
lossguide, and ``Booster.update_many``.

The record feeds the flight record as ``grow_detail`` (rendered by
``python -m xgboost_tpu_torch grow-report``, which reads either package's
flight sinks) and each bracket is emitted as a ``cat="grow"`` Chrome span
nested under the ``round`` span, which ``trace-report`` renders as its
``grow`` breakdown.

The port adds one more record and one more mode of the same seam. The
seam is chosen once per tree (and once per call site outside the grower):

- ``_direct`` (trace off, round unsampled): the call itself, no clock read;
- ``_spanned`` (trace on, round unsampled): a ``step/<op>`` span
  (``cat="step"``) from two clock reads, no sync, for every op of the
  level loop, every sub-op of ``_level_update`` and the round's ops
  outside the grower, so that a device trace's idle gaps can be named by
  the op the host was in;
- ``_bracket`` (a sampled round): as above, unchanged.

On a sampled round ``_level_update``'s sub-ops (``level_update/
with_missing``, ``level_update/eval_splits``, ``level_update/heap_write``
and each strict-order scan inside the first two, ``level_update/scan``,
which also counts the bins it scanned as ``steps`` and reads impl
``cuda:S`` when it launched kernel S, ``csrc/seq_scan.cu``) are host-only
brackets: two clock reads, no sync, no ``host_syncs_total`` count, so
``level_update``'s own bracket reads as before. The round's ops outside
the grower (``gradient``, ``onehot`` when kernel C's one-hot is planned
and built, ``eval_walk`` and ``eval_metric``, at depth -1) are brackets
with a sync before (its wait in the bucket's gap) and one after. Both go
to the port-only ``round_detail`` record on the same flight round
(``grow-report --round-detail`` prints it under the grow table), never
into ``grow_detail``, which stays the JAX package's field for field.

Import discipline: this module imports ONLY stdlib at module scope —
``gbm/gbtree.py`` and ``training.py`` import it eagerly, and torch and the
tree machinery load at the first sampled round.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "should_sample", "arm", "active", "disarm",
    "grow_tree_fused_profiled", "format_grow_detail", "format_grow_diff",
    "round_detail", "round_seam", "format_round_detail", "main",
]

_ENV = "XGBTPU_KERNEL_PROF"

#: the ``driver`` field of every record (the JAX package's value: the
#: numbers come from a host-driven, per-level, instrumented loop)
DRIVER = "instrumented-unrolled"


# ---------------------------------------------------------------------------
# sampling grammar: every=N | rounds=a,b,c
# ---------------------------------------------------------------------------


def _parse(spec: str) -> Tuple[str, Any]:
    kind, sep, val = spec.partition("=")
    if not sep:
        raise ValueError(spec)
    kind = kind.strip()
    if kind == "every":
        n = int(val)
        if n < 1:
            raise ValueError(spec)
        return ("every", n)
    if kind == "rounds":
        rounds = frozenset(int(x) for x in val.split(",") if x.strip())
        if not rounds or min(rounds) < 0:
            raise ValueError(spec)
        return ("rounds", rounds)
    raise ValueError(spec)


# plan memo, lock-guarded: keyed on the RAW env value so a monkeypatched
# spec re-parses and the steady state is one dict hit per round
_PLAN_LOCK = threading.Lock()
_PLAN_MEMO: Dict[str, Optional[Tuple[str, Any]]] = {}


def _plan() -> Optional[Tuple[str, Any]]:
    spec = os.environ.get(_ENV)
    if not spec:
        return None
    with _PLAN_LOCK:
        if spec in _PLAN_MEMO:
            return _PLAN_MEMO[spec]
    try:
        plan: Optional[Tuple[str, Any]] = _parse(spec)
    except (ValueError, TypeError):
        plan = None
        from ..utils import console_logger

        console_logger.warning(
            f"{_ENV}={spec!r} is malformed (grammar: every=N or "
            f"rounds=a,b,c); profiler stays off")
    with _PLAN_LOCK:
        if len(_PLAN_MEMO) > 64:
            _PLAN_MEMO.clear()
        _PLAN_MEMO[spec] = plan
    return plan


def should_sample(round_idx: int) -> bool:
    """Whether round ``round_idx`` is a sampled (profiled) round. With
    the env unset this is one ``os.environ`` read — the whole cost an
    unprofiled run pays per round (pinned ≤2% of a round by
    tests/test_torch_kernelprof.py)."""
    plan = _plan()
    if plan is None:
        return False
    kind, val = plan
    if kind == "every":
        return round_idx % val == 0
    return round_idx in val


# ---------------------------------------------------------------------------
# the per-round profile (armed on the training thread)
# ---------------------------------------------------------------------------


Buckets = Dict[Tuple[str, int], Dict[str, Any]]


def _add(buckets: Buckets, op: str, depth: int, impl: str, host_ns: int,
         inflight_ns: int, gap_ns: int) -> Dict[str, Any]:
    b = buckets.get((op, depth))
    if b is None:
        b = buckets[(op, depth)] = {
            "op": op, "depth": depth, "impl": impl, "count": 0,
            "wall_s": 0.0, "host_s": 0.0, "inflight_s": 0.0,
            "gap_s": 0.0}
    b["count"] += 1
    b["impl"] = impl
    b["wall_s"] += (host_ns + inflight_ns) / 1e9
    b["host_s"] += host_ns / 1e9
    b["inflight_s"] += inflight_ns / 1e9
    b["gap_s"] += gap_ns / 1e9
    return b


def _ops(buckets: Buckets) -> List[Dict[str, Any]]:
    """The buckets by depth, then op name (the JAX package's sort), their
    seconds rounded to the microsecond."""
    return [dict(b,
                 wall_s=round(b["wall_s"], 6),
                 host_s=round(b["host_s"], 6),
                 inflight_s=round(b["inflight_s"], 6),
                 gap_s=round(b["gap_s"], 6))
            for _, b in sorted(buckets.items(),
                               key=lambda kv: (kv[0][1], kv[0][0]))]


class _Profile:
    """Accumulator for ONE sampled round (all trees of the round)."""

    __slots__ = ("round_idx", "buckets", "round_buckets", "host_syncs",
                 "trees", "quant_scales", "_last_done_ns")

    def __init__(self, round_idx: int) -> None:
        self.round_idx = int(round_idx)
        # (op, depth) -> aggregated bucket; depth -1 = pre-level prep
        self.buckets: Buckets = {}
        # the port's own buckets (``round_detail``): _level_update's
        # sub-ops at their level, the round's ops outside the grower at -1
        self.round_buckets: Buckets = {}
        self.host_syncs = 0
        self.trees = 0
        # the round's quantiser grid exponents {"g_exp": Eg, "h_exp": Eh}
        # (dequantize = * 2^-E)
        self.quant_scales: Optional[Dict[str, int]] = None
        self._last_done_ns = 0

    def record(self, op: str, depth: int, impl: str,
               host_ns: int, inflight_ns: int, gap_ns: int) -> None:
        _add(self.buckets, op, depth, impl, host_ns, inflight_ns, gap_ns)
        self.host_syncs += 1

    def note(self, op: str, depth: int, impl: str, host_ns: int,
             inflight_ns: int = 0, gap_ns: int = 0,
             steps: Optional[int] = None) -> None:
        """A ``round_detail`` bucket: outside ``grow_detail`` and its
        ``host_syncs``. ``steps`` (the scan's) adds to the bucket's."""
        b = _add(self.round_buckets, op, depth, impl, host_ns, inflight_ns,
                 gap_ns)
        if steps is not None:
            b["steps"] = b.get("steps", 0) + steps

    def to_record(self) -> Dict[str, Any]:
        ops = _ops(self.buckets)
        # the port has one route: a per-level loop over int64 quantised
        # histograms (no whole-tree kernel, no sibling subtraction)
        return {
            "round": self.round_idx,
            "driver": DRIVER,
            "route": "level",
            "sibling_sub": False,
            "hist_acc": "quant",
            "quant_scales": self.quant_scales,
            "trees": self.trees,
            "host_syncs": self.host_syncs,
            "sum_s": round(sum(b["wall_s"] for b in ops), 6),
            "gap_s": round(sum(b["gap_s"] for b in ops), 6),
            "ops": ops,
        }


_TLS = threading.local()


def arm(round_idx: int) -> _Profile:
    """Open a profile for the sampled round on THIS thread; the depthwise
    grower (``gbtree.boost_one_round``) brackets its ops while one is
    armed."""
    prof = _Profile(round_idx)
    _TLS.profile = prof
    return prof


def active() -> bool:
    return getattr(_TLS, "profile", None) is not None


def round_detail() -> Optional[Dict[str, Any]]:
    """The armed profile's ``round_detail`` record so far (read it before
    ``disarm``), or None when nothing outside ``grow_detail`` was
    recorded."""
    prof = getattr(_TLS, "profile", None)
    if prof is None or not prof.round_buckets:
        return None
    return {"round": prof.round_idx, "trees": prof.trees,
            "ops": _ops(prof.round_buckets)}


def disarm() -> Optional[Dict[str, Any]]:
    """Close the armed profile and return its ``grow_detail`` record —
    or ``None`` when nothing was profiled (not armed, or the round ran a
    path the profiler does not cover: paged / row group / lossguide /
    ``update_many``)."""
    prof = getattr(_TLS, "profile", None)
    _TLS.profile = None
    if prof is None or not prof.buckets:
        return None
    return prof.to_record()


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Hide this thread's armed profile for the duration (``update_many``:
    the JAX package runs those rounds as one scan, which it does not
    profile, and the port keeps that coverage)."""
    prof = getattr(_TLS, "profile", None)
    _TLS.profile = None
    try:
        yield
    finally:
        _TLS.profile = prof


# ---------------------------------------------------------------------------
# the bracket (the grower's step seam on a sampled round)
# ---------------------------------------------------------------------------


def _bracket(prof: _Profile, device) -> Callable[..., Any]:
    """The step seam of a sampled tree on ``device``: runs ``fn`` and
    closes it with a completion sync, recording the op's host-blocked,
    in-flight and gap times, its impl, a ``host_syncs_total`` count and a
    ``grow/<op>`` span."""
    import torch

    from ..tree import hist_kernel as hk
    from . import trace as _trace
    from .metrics import REGISTRY

    counter = REGISTRY.counter(
        "host_syncs_total",
        "Deliberate host round-trips (completion syncs) by site — "
        "nonzero only on kernel-profiled rounds")
    on_card = device.type == "cuda"

    def step(op: str, depth: int, fn: Callable, *args: Any,
             **kwargs: Any) -> Any:
        t0 = time.perf_counter_ns()
        gap_ns = (t0 - prof._last_done_ns) if prof._last_done_ns else 0
        a0, d0 = hk.fused_level.launches, hk.hoisted_level.launches
        out = fn(*args, **kwargs)
        t1 = time.perf_counter_ns()  # the call returned to the host
        if on_card:
            torch.cuda.synchronize(device)  # the sync the seam owns
        if op == "prep":
            # the round's grid, read on sampled rounds only (a copy to
            # the host: already synchronised above)
            g_exp, h_exp = out.gq.exp.tolist()
            prof.quant_scales = {"g_exp": int(g_exp), "h_exp": int(h_exp)}
        t2 = time.perf_counter_ns()
        prof._last_done_ns = t2
        impl = "torch" if on_card else "plain"
        if op == "level_hist" and on_card:
            launched = (hk.hoisted_level.launches - d0,
                        hk.fused_level.launches - a0)
            if launched not in ((1, 0), (0, 1)):
                raise RuntimeError(
                    f"level_hist at depth {depth} launched kernel D "
                    f"{launched[0]} and kernel A {launched[1]} times; "
                    "a level launches exactly one of them once")
            impl = "cuda:D" if launched[0] else "cuda:A"
        counter.labels(site=op).inc()
        prof.record(op, depth, impl, t1 - t0, t2 - t1, gap_ns)
        _trace.emit(f"grow/{op}", t0, t2, cat="grow", depth=depth,
                    impl=impl)
        return out

    return step


#: the sub-op whose bucket also counts ``steps``, the bins it scanned
SCAN = "level_update/scan"


def _sub_bracket(prof: _Profile, device, traced: bool) -> Callable[..., Any]:
    """The seam of ``_level_update``'s sub-ops on a sampled tree: a
    host-only bracket (two clock reads, no sync, no ``host_syncs_total``
    count) into ``round_detail``, so that ``level_update``'s own bracket
    reads as it would without it; traced, a ``step/<op>`` span too. A
    scan's impl is ``cuda:S`` when it launched kernel S
    (``seq_cumsum.launches`` moved across the call)."""
    from ..tree.grow import seq_cumsum
    from . import trace as _trace

    impl = "torch" if device.type == "cuda" else "plain"

    def sub(op: str, depth: int, fn: Callable, *args: Any,
            **kwargs: Any) -> Any:
        s0 = seq_cumsum.launches
        t0 = time.perf_counter_ns()
        out = fn(*args, **kwargs)
        t1 = time.perf_counter_ns()
        scanned = op == SCAN and seq_cumsum.launches != s0
        prof.note(op, depth, "cuda:S" if scanned else impl, t1 - t0,
                  steps=args[0].shape[-1] if op == SCAN else None)
        if traced:
            _trace.emit(f"step/{op}", t0, t1, cat="step", depth=depth)
        return out

    return sub


def _spanned() -> Callable[..., Any]:
    """The step seam of a traced tree or round that is not sampled: a
    ``step/<op>`` span (``cat="step"``) from two clock reads around the
    call, with no sync, so that a device trace's idle gaps can be named by
    the op the host was in."""
    from . import trace as _trace

    def step(op: str, depth: int, fn: Callable, *args: Any,
             **kwargs: Any) -> Any:
        t0 = time.perf_counter_ns()
        out = fn(*args, **kwargs)
        _trace.emit(f"step/{op}", t0, time.perf_counter_ns(), cat="step",
                    depth=depth)
        return out

    return step


def _round_bracket(prof: _Profile, device, traced: bool) -> Callable[..., Any]:
    """The seam of a sampled round's ops outside the grower (``gradient``,
    ``onehot``, ``eval_walk``, ``eval_metric``; depth -1): a sync before
    the op, its wait charged to the bucket's gap, and one after, as the
    grower's bracket, into ``round_detail`` and outside ``host_syncs_total``.
    Traced, a ``step/<op>`` span too, but for ``gradient``: the Monitor's
    ``GetGradient`` span already covers it."""
    import torch

    from . import trace as _trace

    on_card = device.type == "cuda"
    impl = "torch" if on_card else "plain"

    def step(op: str, depth: int, fn: Callable, *args: Any,
             **kwargs: Any) -> Any:
        g0 = time.perf_counter_ns()
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        out = fn(*args, **kwargs)
        t1 = time.perf_counter_ns()
        if on_card:
            torch.cuda.synchronize(device)
        t2 = time.perf_counter_ns()
        prof.note(op, depth, impl, t1 - t0, t2 - t1, t0 - g0)
        if traced and op != "gradient":
            _trace.emit(f"step/{op}", t0, t2, cat="step", depth=depth)
        return out

    return step


def round_seam(device) -> Optional[Callable[..., Any]]:
    """The seam of the round's ops outside the grower, chosen once per
    call site: on a sampled round the bracket, with the trace on a
    ``step/<op>`` span, else None (the caller makes the call itself)."""
    prof = getattr(_TLS, "profile", None)
    from . import trace as _trace

    if prof is not None:
        return _round_bracket(prof, device, _trace.enabled())
    return _spanned() if _trace.enabled() else None


def grow_tree_fused_profiled(bins, grad, hess, cut_values, eta, gamma, cfg,
                             onehot=None, bins_t=None, key=None,
                             feature_weights=None, group=None):
    """``grow_tree_fused`` for a sampled round: the same level loop with
    every op bracketed at its step seam. Falls back to the production call
    when no profile is armed or under a row ``group`` (the profiler is
    single-process by design, as the JAX package's is outside a mesh)."""
    from ..tree import grow_fused as _gf

    prof = getattr(_TLS, "profile", None)
    if prof is None or group is not None:
        return _gf.grow_tree_fused(
            bins, grad, hess, cut_values, eta, gamma, cfg, onehot=onehot,
            bins_t=bins_t, key=key, feature_weights=feature_weights,
            group=group)

    from . import trace as _trace

    prof.trees += 1
    # start the gap clock at entry so the setup before the first bracket
    # lands in prep's gap column instead of vanishing from the attribution
    prof._last_done_ns = time.perf_counter_ns()
    step = _bracket(prof, bins.device)
    sub = _sub_bracket(prof, bins.device, _trace.enabled())
    with _trace.span("grow_tree", fused=True, instrumented=True,
                     depth=cfg.max_depth, features=int(bins.shape[1])):
        return _gf._grow_tree_fused(bins, grad, hess, cut_values, eta,
                                    gamma, cfg, onehot, bins_t, key,
                                    feature_weights, None, step=step,
                                    sub=sub)


# ---------------------------------------------------------------------------
# grow-report: render grow_detail records from a flight sink
# ---------------------------------------------------------------------------


def format_grow_detail(rec: Dict[str, Any],
                       grow_s: Optional[float] = None) -> str:
    """Render one ``grow_detail`` record as the per-depth × per-op table.
    ``grow_s`` (the round's ``stages.grow``) adds the coverage line —
    the acceptance contract is substages summing to within 10% of it."""
    route = rec.get("route")
    route_note = ""
    if route:
        route_note = f", route={route}"
        if route == "tree_grow":
            # the JAX package's per-level replay of a one-dispatch round;
            # the resolved hist_acc impl picks the replay flavour, and the
            # quant flavour shows the round's quantiser grid
            if rec.get("hist_acc") == "quant":
                route_note += " (quant replay"
                qs = rec.get("quant_scales") or {}
                if qs:
                    route_note += (f", scales g=2^-{qs.get('g_exp')}"
                                   f" h=2^-{qs.get('h_exp')}")
                route_note += ")"
            elif rec.get("sibling_sub"):
                route_note += " (sibling-sub replay)"
            else:
                route_note += " (per-level replay)"
    lines = [
        f"round {rec.get('round')}: grow detail "
        f"({rec.get('driver')}, {rec.get('trees')} tree(s){route_note})",
        f"  {'depth':>5} {'op':<16} {'impl':<8} {'count':>5} "
        f"{'wall':>10} {'host':>10} {'inflight':>10} {'gap':>9}",
    ]

    def ms(v: float) -> str:
        return f"{v * 1e3:.3f}ms"

    for b in rec.get("ops", ()):
        depth = b.get("depth", -1)
        lines.append(
            f"  {('prep' if depth < 0 else depth)!s:>5} {b['op']:<16} "
            f"{b.get('impl', '?'):<8} {b.get('count', 0):>5} "
            f"{ms(b['wall_s']):>10} {ms(b.get('host_s', 0.0)):>10} "
            f"{ms(b.get('inflight_s', 0.0)):>10} "
            f"{ms(b.get('gap_s', 0.0)):>9}")
    total = f"  substages {ms(rec.get('sum_s', 0.0))}, " \
            f"dispatch gap {ms(rec.get('gap_s', 0.0))}, " \
            f"host syncs {rec.get('host_syncs', 0)}"
    if grow_s:
        total += (f"; stages.grow {ms(grow_s)} "
                  f"(substages = {100.0 * rec.get('sum_s', 0.0) / grow_s:.1f}%)")
    lines.append(total)
    return "\n".join(lines)


#: ``_level_update``'s three sub-ops, which share out its host time
LEVEL_SUB_OPS = ("level_update/with_missing", "level_update/eval_splits",
                 "level_update/heap_write")


def format_round_detail(rec: Dict[str, Any],
                        grow: Optional[Dict[str, Any]] = None) -> str:
    """Render one ``round_detail`` record (the port's own) as a table in
    ``grow-report``'s columns, plus ``steps`` for the scans. ``grow`` (the
    round's ``grow_detail``) adds the coverage line: the three sub-ops'
    host time against ``level_update``'s."""
    lines = [
        f"round {rec.get('round')}: round detail ({rec.get('trees')} "
        f"tree(s); level_update sub-ops by depth, the round's other ops "
        f"at -1)",
        f"  {'depth':>5} {'op':<26} {'impl':<6} {'count':>5} "
        f"{'wall':>10} {'host':>10} {'inflight':>10} {'gap':>9} "
        f"{'steps':>6}",
    ]

    def ms(v: float) -> str:
        return f"{v * 1e3:.3f}ms"

    for b in rec.get("ops", ()):
        steps = b.get("steps")
        lines.append(
            f"  {b.get('depth', -1)!s:>5} {b['op']:<26} "
            f"{b.get('impl', '?'):<6} {b.get('count', 0):>5} "
            f"{ms(b['wall_s']):>10} {ms(b.get('host_s', 0.0)):>10} "
            f"{ms(b.get('inflight_s', 0.0)):>10} "
            f"{ms(b.get('gap_s', 0.0)):>9} "
            f"{'' if steps is None else steps:>6}")
    ops = rec.get("ops", ())
    sub = sum(b.get("host_s", 0.0) for b in ops if b["op"] in LEVEL_SUB_OPS)
    scan = [b for b in ops if b["op"] == SCAN]
    total = (f"  sub-ops host {ms(sub)}, of it scans "
             f"{ms(sum(b.get('host_s', 0.0) for b in scan))} "
             f"({sum(b.get('steps', 0) for b in scan)} steps)")
    lu = sum(b.get("host_s", 0.0) for b in (grow or {}).get("ops", ())
             if b.get("op") == "level_update")
    if lu:
        total += (f"; level_update host {ms(lu)} "
                  f"(sub-ops = {100.0 * sub / lu:.1f}%)")
    lines.append(total)
    return "\n".join(lines)


def _aggregate_ops(recs: List[Dict[str, Any]]) -> Tuple[
        Dict[Tuple[int, str], Dict[str, Any]], List[int]]:
    """Sum per-(depth, op) wall seconds across sampled round records —
    the input to the ``--diff`` table. Returns ``(buckets, rounds)``."""
    agg: Dict[Tuple[int, str], Dict[str, Any]] = {}
    rounds: List[int] = []
    for r in recs:
        gd = r.get("grow_detail", {})
        rounds.append(gd.get("round", r.get("round", -1)))
        for b in gd.get("ops", ()):
            key = (b.get("depth", -1), b.get("op", "?"))
            cur = agg.setdefault(key, {"wall_s": 0.0, "count": 0,
                                       "impl": b.get("impl", "?")})
            cur["wall_s"] += b.get("wall_s", 0.0)
            cur["count"] += b.get("count", 0)
            cur["impl"] = b.get("impl", cur["impl"])
    return agg, rounds


def format_grow_diff(agg_a: Dict[Tuple[int, str], Dict[str, Any]],
                     rounds_a: List[int], label_a: str,
                     agg_b: Dict[Tuple[int, str], Dict[str, Any]],
                     rounds_b: List[int], label_b: str) -> str:
    """Render the A-vs-B per-depth × per-op table with a delta column
    (B − A; negative = B faster). Rows missing on one side show '-' —
    e.g. a depth the other run never grew, or an op only one route
    runs."""
    lines = [
        f"grow detail diff: A = {label_a} (rounds {sorted(set(rounds_a))}) "
        f"vs B = {label_b} (rounds {sorted(set(rounds_b))})",
        f"  {'depth':>5} {'op':<16} {'impl':<16} {'A wall':>10} "
        f"{'B wall':>10} {'delta':>10}",
    ]

    def ms(v: Optional[float]) -> str:
        return "-" if v is None else f"{v * 1e3:.3f}ms"

    tot_a = tot_b = 0.0
    changed = 0
    for depth, op in sorted(set(agg_a) | set(agg_b)):
        a = agg_a.get((depth, op))
        b = agg_b.get((depth, op))
        wa = a["wall_s"] if a else None
        wb = b["wall_s"] if b else None
        tot_a += wa or 0.0
        tot_b += wb or 0.0
        ia = a["impl"] if a else "-"
        ib = b["impl"] if b else "-"
        impl = ia if ia == ib else f"{ia}->{ib}"
        delta = "-" if (wa is None or wb is None) else ms(wb - wa)
        # rows whose impl changed between the runs (cuda:D -> cuda:A, say)
        # get a visible marker
        mark = ""
        if ia != ib and a is not None and b is not None:
            mark = " *"
            changed += 1
        lines.append(
            f"  {('prep' if depth < 0 else depth)!s:>5} {op:<16} "
            f"{impl:<16} {ms(wa):>10} {ms(wb):>10} {delta:>10}{mark}")
    lines.append(f"  substages A {ms(tot_a)}, B {ms(tot_b)}, "
                 f"delta {ms(tot_b - tot_a)}")
    if changed:
        lines.append(f"  * = resolved impl changed between runs "
                     f"({changed} row(s))")
    return "\n".join(lines)


def _iter_flight_lines(path: str) -> List[Dict[str, Any]]:
    """Parse a flight.jsonl tolerantly: torn/partial lines (SIGKILL
    mid-write) are skipped, not fatal."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def _find_flight_files(arg: str) -> List[str]:
    if os.path.isdir(arg):
        import glob as _glob

        hits = sorted(
            _glob.glob(os.path.join(arg, "obs", "rank*", "flight.jsonl"))
            or _glob.glob(os.path.join(arg, "flight.jsonl")))
        return hits
    return [arg]


def main(argv: List[str]) -> int:
    usage = ("usage: python -m xgboost_tpu_torch grow-report "
             "<flight.jsonl|run-dir> [--round N] | "
             "grow-report --diff <A> <B> [--round N]")
    if not argv or argv[0] in ("-h", "--help"):
        print(usage, file=sys.stderr)
        return 0 if argv else 1
    # the port's round_detail under each grow table (the default output
    # stays the JAX package's, line for line)
    with_round = "--round-detail" in argv
    argv = [a for a in argv if a != "--round-detail"]
    want_round: Optional[int] = None
    if "--round" in argv:
        i = argv.index("--round")
        try:
            want_round = int(argv[i + 1])
        except (IndexError, ValueError):
            print(usage, file=sys.stderr)
            return 1
        argv = argv[:i] + argv[i + 2:]
    if "--diff" in argv:
        rest = [a for a in argv if a != "--diff"]
        if len(rest) != 2:
            print(usage, file=sys.stderr)
            return 1
        sides = []
        for arg in rest:
            recs: List[Dict[str, Any]] = []
            for path in _find_flight_files(arg):
                try:
                    recs.extend(
                        r for r in _iter_flight_lines(path)
                        if r.get("t") == "round" and "grow_detail" in r)
                except OSError as e:
                    print(f"{path}: {e}", file=sys.stderr)
                    return 1
            if want_round is not None:
                recs = [r for r in recs if r.get("round") == want_round]
            if not recs:
                print(f"{arg}: no sampled grow_detail records found "
                      f"(profiler arms via {_ENV}=every=N|rounds=a,b,c)",
                      file=sys.stderr)
                return 1
            sides.append((arg, recs))
        (la, ra), (lb, rb) = sides
        agg_a, rounds_a = _aggregate_ops(ra)
        agg_b, rounds_b = _aggregate_ops(rb)
        print(format_grow_diff(agg_a, rounds_a, la, agg_b, rounds_b, lb))
        return 0
    paths = _find_flight_files(argv[0])
    if not paths:
        print(f"{argv[0]}: no flight.jsonl found", file=sys.stderr)
        return 1
    rc = 0
    shown = 0
    for path in paths:
        try:
            recs = _iter_flight_lines(path)
        except OSError as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
            continue
        sampled = [r for r in recs
                   if r.get("t") == "round" and "grow_detail" in r]
        if want_round is not None:
            sampled = [r for r in sampled if r.get("round") == want_round]
        for r in sampled:
            print(format_grow_detail(
                r["grow_detail"], r.get("stages", {}).get("grow")))
            if with_round and "round_detail" in r:
                print(format_round_detail(r["round_detail"],
                                          r["grow_detail"]))
            print()
            shown += 1
    if not shown:
        print("no sampled grow_detail records found "
              f"(profiler arms via {_ENV}=every=N|rounds=a,b,c)",
              file=sys.stderr)
        return 1
    return rc

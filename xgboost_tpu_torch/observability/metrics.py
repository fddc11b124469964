"""Metrics registry: named counters / gauges / histograms.

The port's own copy of the JAX package's ``observability/metrics.py`` (a
module with no JAX in it; the port imports nothing of that package), with
the same text and JSON exposition. One process-wide registry
(``REGISTRY``) holds every telemetry series: training progress
(``rounds_total``, ``round_seconds``), tree shape (``tree_depth``,
``split_gain``), host-side phase timings (``monitor_seconds`` via the
``utils.timer.Monitor`` adapter) and collective volume
(``collective_ops_total`` / ``collective_bytes_total``, see
``observability.comms``). Two export surfaces:

- ``REGISTRY.exposition()``: Prometheus text exposition format, ready to
  serve from a ``/metrics`` endpoint or drop into a textfile collector;
- ``REGISTRY.snapshot()``: a JSON-able dict for result files and
  programmatic assertions.

Family/child creation is lock-guarded; value updates are plain float ops
(a counter bump may race across threads at worst by one sample, the right
trade for instrumentation that sits on training hot paths). Metric
families are created lazily on first use so importing this module costs
nothing.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "REGISTRY", "get_registry",
]

# default histogram buckets: exponential seconds ladder, good for host-side
# phase timings from ~100us dispatches to multi-minute fits
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotone accumulator."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        self.value += amount


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Fixed-bucket histogram: cumulative-bucket Prometheus semantics."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        self.count += 1
        # linear scan: bucket lists are short and observations host-side
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 < q <= 1) from the bucket counts —
        Prometheus ``histogram_quantile`` semantics: linear interpolation
        inside the bucket the target rank falls in, clamped to the
        largest finite bound when the rank lands in the +Inf bucket.
        None when nothing was observed. The estimate's resolution is the
        bucket ladder (choose buckets for the latencies you care about);
        p50/p99 from this are what the serving latency and round-time
        series report (docs/observability.md)."""
        if self.count == 0:
            return None
        target = max(min(float(q), 1.0), 0.0) * self.count
        cum = 0.0
        lo = 0.0
        for ub, c in zip(self.buckets, self.counts):
            if c and cum + c >= target:
                frac = (target - cum) / c
                return lo + (ub - lo) * min(max(frac, 0.0), 1.0)
            cum += c
            lo = ub
        return float(self.buckets[-1])  # +Inf bucket: clamp


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """A named metric plus its labelled children. The family itself is
    usable directly (the empty-label child): ``fam.inc()``,
    ``fam.observe(x)``; labelled series via ``fam.labels(op="psum")``."""

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None) -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind: {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self._buckets = tuple(buckets) if buckets is not None else None
        self._children: Dict[_LabelKey, Any] = {}
        self._lock = threading.Lock()

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self._buckets or DEFAULT_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, **labelset: Any):
        key: _LabelKey = tuple(sorted(
            (k, str(v)) for k, v in labelset.items()))
        child = self._children.get(key)  # a dict read: no lock on a hit
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make()
            return child

    # -- empty-label convenience forwarding ---------------------------------
    def _root(self):
        """The empty-label child; once it exists, without ``labels()``'s
        sort and lock (the serving path bumps these per request)."""
        child = self._children.get(())
        return child if child is not None else self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._root().inc(amount)

    def set(self, value: float) -> None:
        self._root().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._root().dec(amount)

    def observe(self, value: float) -> None:
        self._root().observe(value)

    @property
    def value(self) -> float:
        return self._root().value

    def series(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._children.items())]


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    def __init__(self) -> None:
        self._families: Dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, kind: str, help: str,
                buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        fam = self._families.get(name)  # a dict read: no lock on a hit
        if fam is not None and fam.kind == kind:
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = MetricFamily(
                    name, kind, help, buckets)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            return fam

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        return self._family(name, "histogram", help, buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        return self._families.get(name)

    def quantile(self, name: str, q: float, **labels: Any
                 ) -> Optional[float]:
        """Estimated q-quantile of a histogram series, or None when the
        family is absent, not a histogram, or the labelled child has no
        observations — the one-call read the serving admission controller
        uses for its p99-based shed estimate (``docs/serving.md``)."""
        fam = self._families.get(name)
        if fam is None or fam.kind != "histogram":
            return None
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with fam._lock:
            child = fam._children.get(key)
        return None if child is None else child.quantile(q)

    def quantiles(self, name: str, qs: Sequence[float] = (0.50, 0.99)
                  ) -> List[Tuple[Dict[str, str], Dict[str, float]]]:
        """Quantile estimates for EVERY series of a histogram family:
        ``[(labels, {"p50": v, "p99": v}), ...]``, skipping series with
        no observations. The one-call read the serving SLO ledger and the
        ``stats`` op use to report per-model stage latencies without
        walking a full ``snapshot()``."""
        fam = self._families.get(name)
        if fam is None or fam.kind != "histogram":
            return []
        out: List[Tuple[Dict[str, str], Dict[str, float]]] = []
        for labels, child in fam.series():
            if not child.count:
                continue
            out.append((labels, {f"p{float(q) * 100:g}":
                                 child.quantile(q) for q in qs}))
        return out

    def reset(self) -> None:
        """Drop every family (tests / between BENCH repetitions)."""
        with self._lock:
            self._families.clear()

    # ------------------------------------------------------------------
    # export surfaces
    # ------------------------------------------------------------------
    def exposition(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    cum = child.cumulative()
                    for ub, c in zip(child.buckets, cum):
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_fmt_labels(labels, f'le={json.dumps(_fmt_value(ub))}')}"
                            f" {c}")
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(labels, 'le=' + json.dumps('+Inf'))}"
                        f" {cum[-1]}")
                    lines.append(
                        f"{fam.name}_sum{_fmt_labels(labels)}"
                        f" {_fmt_value(child.sum)}")
                    lines.append(
                        f"{fam.name}_count{_fmt_labels(labels)}"
                        f" {child.count}")
                else:
                    lines.append(
                        f"{fam.name}{_fmt_labels(labels)}"
                        f" {_fmt_value(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dict of every series' current state."""
        out: Dict[str, Any] = {}
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            series = []
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "sum": child.sum,
                        "count": child.count,
                        "p50": child.quantile(0.50),
                        "p99": child.quantile(0.99),
                        "buckets": {
                            _fmt_value(ub): c
                            for ub, c in zip(child.buckets,
                                             child.cumulative())
                        },
                    })
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {
                "type": fam.kind, "help": fam.help, "series": series,
            }
        return out


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY

"""Collective accounting: operations, bytes and seconds per call site.

The port of the JAX package's ``observability/comms.py``, and the port's one
record of its collectives. Every collective of the port is a host call
(``collective.all_reduce`` on device tensors, ``collective.process_allgather``
on host payloads), so each one records itself as it runs, with its exact
payload, under its call site and the JAX package's kind of that site:

- ``psum_hist``: the grower's sums over a row group, each level's (or
  each lossguide step's) histogram and the root totals (``all_reduce``
  sites ``level_hist``, ``lossguide_hist``, ``root_totals``);
- ``pmax``: the gradient scale's maximum (site ``grad_scale``);
- ``process_allgather``: every host gather (the hoist plan, the sketch's
  summaries, the metric pairs, the rabit shim's ``allreduce`` and
  ``broadcast``), whatever its site.

Any other site is its own kind. The bytes are the port's own wire, not the
JAX package's float32 psums: the histograms cross ranks as int64 fixed-point
sums, ``[F, 2K, B]`` of 8 bytes a cell (``grow_psum_bytes``), the root
totals as int64 ``[2]`` and the scale as float32 ``[2]``.

Metric families (in ``observability.metrics.REGISTRY``), labelled
``op`` (the kind) and ``site``:

- ``collective_ops_total``: collective operations;
- ``collective_bytes_total``: payload bytes reduced or gathered;
- ``collective_seconds_total``: host seconds of the device all-reduces,
  each between two device synchronizations, only while
  ``collective.timing`` is on.

``snapshot()`` sums them per kind, ``{op: {"ops": n, "bytes": b}}``;
``snapshot(by="site")`` gives ``{site: {"ops", "bytes", "seconds"}}``. The
JAX package's ``record`` is also its ``collective`` chaos site; the port's
gains that site with the resilience layer.
"""

from __future__ import annotations

from typing import Dict, Optional

from .metrics import REGISTRY

__all__ = ["record", "snapshot", "grow_psum_bytes", "kind_of"]

_OPS_HELP = "Logical collective operations by kind"
_BYTES_HELP = "Payload bytes moved through collectives by kind"
_SECONDS_HELP = "Host seconds of timed device all-reduces by kind"

#: ``collective.all_reduce`` sites -> the JAX package's kinds
_SITE_KIND = {"level_hist": "psum_hist", "lossguide_hist": "psum_hist",
              "root_totals": "psum_hist", "grad_scale": "pmax"}

#: bytes of the root totals (int64 [2]) and the gradient scale (f32 [2])
_TREE_FIXED_BYTES = 2 * 8 + 2 * 4

_FAMILIES = (("collective_ops_total", "ops"),
             ("collective_bytes_total", "bytes"),
             ("collective_seconds_total", "seconds"))


def kind_of(site: str) -> str:
    """The kind an ``all_reduce`` site is counted under."""
    return _SITE_KIND.get(site, site)


def record(site: str, nbytes: int, n_ops: int = 1, *,
           op: Optional[str] = None,
           seconds: Optional[float] = None) -> None:
    """Account ``n_ops`` collective operations at ``site`` moving
    ``nbytes`` payload bytes in all, under the kind ``op`` (default
    ``kind_of(site)``), and ``seconds`` of host time when given. Doubles
    as the ``collective`` chaos site: every accounted collective passes
    here, so ``XGBTPU_CHAOS="collective:..."`` scripts a failing reduction
    (lazy import: the resilience layer depends on this package)."""
    from ..resilience import chaos

    chaos.hit("collective")
    labels = dict(op=op or kind_of(site), site=site)
    REGISTRY.counter("collective_ops_total", _OPS_HELP).labels(
        **labels).inc(n_ops)
    REGISTRY.counter("collective_bytes_total", _BYTES_HELP).labels(
        **labels).inc(nbytes)
    if seconds is not None:
        REGISTRY.counter("collective_seconds_total", _SECONDS_HELP).labels(
            **labels).inc(seconds)


def snapshot(by: str = "op") -> Dict[str, Dict[str, float]]:
    """The counters summed per kind (``by="op"``: ops and bytes) or per
    call site (``by="site"``: ops, bytes and seconds)."""
    out: Dict[str, Dict[str, float]] = {}
    for name, key in _FAMILIES:
        fam = REGISTRY.get(name)
        if fam is None or (by == "op" and key == "seconds"):
            continue
        for labels, child in fam.series():
            row = out.setdefault(labels.get(by, ""), {"ops": 0.0,
                                                      "bytes": 0.0})
            row[key] = row.get(key, 0.0) + child.value
    return out


def grow_psum_bytes(max_depth: int, n_features: int, max_bin: int) -> int:
    """Bytes a depthwise tree all-reduces over a row group: one int64
    ``[F, 2K, B]`` histogram a level (K doubling each level), the int64
    root totals and the float32 gradient scale."""
    total = _TREE_FIXED_BYTES
    for d in range(max_depth):
        total += n_features * (2 << d) * max_bin * 8
    return total

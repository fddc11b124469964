"""Serving fast path: row bucketing and the serving predict with its
latency series.

The port of the JAX package's ``predictor/serving.py``. There, every new
batch size is a fresh XLA compile, so rows pad to power-of-two buckets and
one compiled program is cached per (bucket, forest shape, output kind).
Eager PyTorch compiles nothing per shape, so here rows are walked as
given (no padding) and there is no program cache: the bucket is stamped
on the serving records, so a stream of sizes in [1, 4096] reads as at
most 9 buckets in both packages.

- **row bucketing** (``bucket_rows``): the JAX package's schedule, letter
  for letter: minimum 16, powers of two up to 8192, multiples of 8192
  beyond.
- **the walk** (``predict_serving``): one host-to-device copy of the rows,
  ``predictor.predict_margin`` (kernel B for a numerical forest on the
  card, the categorical walk for a categorical forest, the plain version
  for CPU tensors), the objective's ``pred_transform`` on the device, one
  device-to-host copy. CSR input goes through ``CSRStorage`` row blocks
  made dense on the host, so CSR equals dense bit for bit.
- **observability**: ``inplace_predict_rows_total`` and the
  ``predict_latency_seconds`` histogram (with a ``model=`` child inside
  ``serving_context``).

``last_route()`` reports what ran: ``kernel`` (kernel B), ``torch`` (the
plain version or the categorical walk) or ``base`` (no trees).

Not ported, on purpose: the JAX package's compiled-program cache
(``ServingCache``, ``XGBTPU_SERVING_CACHE_SIZE`` and the
``predict_bucket_cache_*`` series: nothing is compiled, so an entry would
be the same walk for every key), its walk routing through its dispatch
registry (``_resolve_walk``, ``dispatch.resolve``), its native CPU walker
(``_HostForest``, ``_native_margin``; a route that would serve a faulting
device walk from the host, the fallback the port forbids) and its
retrace guard (``guard_jit``, ``note_retrace``, ``_PALLAS_COUNTED``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..data.sparse import CSRStorage
from ..observability import REGISTRY as _REGISTRY
from . import StackedForest, predict_margin

__all__ = ["bucket_rows", "predict_serving", "serving_context",
           "last_route", "row_blocks"]

_POW2_CAP = 8192  # largest power-of-two bucket
_BIG_STEP = 8192  # above the cap: round up to a multiple of this
_MIN_BUCKET = 16  # tiny batches share one bucket

#: rows per host-densified block of a CSR input
_CSR_BLOCK = 65536


def bucket_rows(n: int) -> int:
    """Bucket of a batch of ``n`` rows."""
    if n <= _MIN_BUCKET:
        return _MIN_BUCKET
    if n <= _POW2_CAP:
        return 1 << (n - 1).bit_length()
    return -(-n // _BIG_STEP) * _BIG_STEP


def row_blocks(storage: CSRStorage, device: torch.device,
               blk: int = _CSR_BLOCK):
    """``(lo, hi, X)`` over a CSR's rows: each block of ``blk`` rows made
    dense on the host (NaN where absent) and sent to ``device`` (one empty
    block for no rows)."""
    n = storage.shape[0]
    for lo in range(0, max(n, 1), blk):
        hi = min(lo + blk, n)
        yield lo, hi, torch.as_tensor(storage.dense_rows(lo, hi),
                                      device=device)


#: per-thread serving context set by the model server's dispatch loop
#: (``serving/batcher.py``): the tenant label of the latency series, and
#: the route the thread's last ``predict_serving`` took
_SERVING_TLS = threading.local()


@contextlib.contextmanager
def serving_context(model: str = "") -> Iterator[None]:
    """Scope every ``predict_serving`` call on this thread to a tenant.

    ``model`` labels the request's ``predict_latency_seconds`` sample
    (``{model="name@vN"}``). Contexts nest; the innermost wins. Entering
    clears :func:`last_route` (exiting does not restore it), so a dispatch
    that never reaches ``predict_serving`` (a linear booster predicting
    through a DMatrix) reads as ``""`` afterwards."""
    prev = getattr(_SERVING_TLS, "model", "")
    _SERVING_TLS.model = model
    _SERVING_TLS.route = ""
    try:
        yield
    finally:
        _SERVING_TLS.model = prev


def last_route() -> str:
    """Which route the most recent ``predict_serving`` call on THIS thread
    took: ``kernel`` (kernel B on the card), ``torch`` (the plain version
    on the CPU, or the categorical walk) or ``base`` (no trees); ``""``
    before the first call on a thread and after a ``serving_context``
    dispatch that bypassed ``predict_serving``."""
    return getattr(_SERVING_TLS, "route", "")


def _note_route(route: str) -> str:
    _SERVING_TLS.route = route
    return route


#: serving latencies run from tens of microseconds (a small batch) to
#: seconds (a library's first load): a finer ladder than the default
_LATENCY_BUCKETS = (
    0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def predict_serving(
    forest: StackedForest,
    X,
    base,
    tree_weights: Optional[torch.Tensor] = None,
    transform: Optional[Callable] = None,
) -> np.ndarray:
    """Margins (or transformed outputs) of raw rows, as a host numpy array
    of ``n`` rows. ``X`` is ``[n, F]`` float32 with NaN missing, or a
    ``CSRStorage`` / scipy sparse matrix (row blocks made dense on the
    host). ``base`` is ``[n, K]`` (numpy, or a tensor on the forest's
    device); ``transform`` is an objective's ``pred_transform``, run on
    the device. Every call observes into ``predict_latency_seconds``."""
    t0 = time.perf_counter()
    out = _predict_serving_impl(forest, X, base, tree_weights, transform)
    fam = _REGISTRY.histogram(
        "predict_latency_seconds",
        "End-to-end serving predict latency per request",
        buckets=_LATENCY_BUCKETS)
    dt = time.perf_counter() - t0
    # the unlabelled child stays the process-wide series (admission's p99
    # estimate reads it); a tenant label adds a per-model series beside it
    fam.observe(dt)
    model = getattr(_SERVING_TLS, "model", "")
    if model:
        fam.labels(model=model).observe(dt)
    return out


def _predict_serving_impl(forest, X, base, tree_weights, transform
                          ) -> np.ndarray:
    if hasattr(X, "tocsr") and not hasattr(X, "dense_rows"):
        X = CSRStorage(X)
    device = forest.cond.device
    n = X.shape[0]
    _REGISTRY.counter(
        "inplace_predict_rows_total",
        "Rows served through the inplace/serving fast path").inc(n)
    if not (isinstance(base, torch.Tensor) and base.dtype == torch.float32
            and base.device == device):
        base = torch.as_tensor(base, dtype=torch.float32, device=device)
    if forest.num_trees == 0:  # no trees: margins are the base alone
        _note_route("base")
        out = base if transform is None else transform(
            base[:, 0] if max(forest.n_groups, 1) == 1 else base)
        return out.cpu().numpy()[:n]
    _note_route("torch" if device.type == "cpu" or forest.has_cats
                else "kernel")
    if hasattr(X, "dense_rows"):
        out = torch.cat([_walk(forest, Xb, base[lo:hi], tree_weights,
                               transform)
                         for lo, hi, Xb in row_blocks(X, device)])
    else:
        out = _walk(forest, torch.as_tensor(np.ascontiguousarray(X),
                                            device=device),
                    base, tree_weights, transform)
    return out.cpu().numpy()


def _walk(forest: StackedForest, X: torch.Tensor, base: torch.Tensor,
          tree_weights: Optional[torch.Tensor],
          transform: Optional[Callable]) -> torch.Tensor:
    """The walk and the output transform, both on the forest's device."""
    margin = predict_margin(forest, X, base, tree_weights)
    if transform is None:
        return margin
    return transform(margin[:, 0] if forest.n_groups <= 1 else margin)

"""The model server over the serving fast path (the port of the JAX
package's ``serving/``; ``predictor/serving.py`` is the fast path).

- :mod:`.batcher`: async micro-batching, concurrent small requests
  coalesced into one dispatch (one kernel B launch on the card);
- :mod:`.tenancy`: the multi-model arena, boosters resident by
  ``name@version`` under an LRU memory budget, and the weighted-fair
  request queue;
- :mod:`.swap`: zero-downtime hot swap, load -> warm -> flip -> drain;
- :mod:`.admission`: SLO-aware admission (deadline, queue depth,
  per-model p99, tenant quota sheds);
- :mod:`.obs`: request-scope observability (request ids, traces, access
  log, the per-dispatch flight ring, the SLO ledger);
- :mod:`.faults`: batch fault isolation with bisection re-dispatch (a
  typed ``RequestError`` for exactly the poison members), per-model
  circuit breakers, input quarantine, the batcher watchdog;
- :mod:`.delivery`: continuous train-to-serve delivery (watch, publish,
  canary, gate, promote, auto-rollback).

Entry points: :class:`ModelServer` in Python, ``python -m
xgboost_tpu_torch serve`` for the JSONL stdin/socket protocol. Not ported
yet: the JAX package's fleet tier (``serving/fleet``) and
``serve-report``. Not ported, on purpose: its degrade routing to a native
CPU walker (a faulting launch takes the fault ladder instead).
"""

from .admission import AdmissionController, RequestShed  # noqa: F401
from .batcher import MicroBatcher  # noqa: F401
from .delivery import (  # noqa: F401
    CanaryRouter, CanaryState, DeliveryController,
)
from .faults import (  # noqa: F401
    CircuitBreaker, FaultDomain, Quarantine, RequestError,
)
from .obs import ServingRecorder, SLOLedger  # noqa: F401
from .server import ModelServer, serve_main  # noqa: F401
from .swap import hot_swap, promote_live  # noqa: F401
from .tenancy import (  # noqa: F401
    ModelEntry, ModelRegistry, TenantFairQueue,
)

__all__ = [
    "AdmissionController", "CanaryRouter", "CanaryState", "CircuitBreaker",
    "DeliveryController", "FaultDomain", "MicroBatcher",
    "ModelEntry", "ModelRegistry", "ModelServer", "Quarantine",
    "RequestError", "RequestShed", "SLOLedger", "ServingRecorder",
    "TenantFairQueue", "hot_swap", "promote_live", "serve_main",
]

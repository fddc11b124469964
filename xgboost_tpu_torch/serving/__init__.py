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
  canary, gate, promote, auto-rollback);
- :mod:`.fleet`: N replica processes behind a consistent-hash router,
  supervised and respawned from one shared manifest.

Entry points: :class:`ModelServer` in Python, ``python -m
xgboost_tpu_torch serve`` for the JSONL stdin/socket protocol, ``python -m
xgboost_tpu_torch serve-fleet`` for the replicated tier and ``serve-report``
(``observability/serve_report.py``) for what the traffic looked like. Not
ported, on purpose: the JAX package's degrade routing to a native CPU
walker (a faulting launch takes the fault ladder instead).
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
from .fleet import (  # noqa: F401
    FleetSupervisor, HashRing, ReplicaEndpoint, Router, serve_fleet_main,
)

__all__ = [
    "AdmissionController", "CanaryRouter", "CanaryState", "CircuitBreaker",
    "DeliveryController", "FaultDomain", "FleetSupervisor", "HashRing",
    "MicroBatcher", "ModelEntry", "ModelRegistry", "ModelServer",
    "Quarantine", "ReplicaEndpoint", "RequestError", "RequestShed",
    "Router", "SLOLedger", "ServingRecorder", "TenantFairQueue",
    "hot_swap", "promote_live", "serve_fleet_main", "serve_main",
]

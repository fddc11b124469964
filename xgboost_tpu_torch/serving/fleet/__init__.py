"""The serving fleet: replicated crash-only servers behind a routing
front (the port of the JAX package's ``serving/fleet``).

Three pieces compose the single-process server (``serving/server.py``)
into an N-replica fleet:

- :mod:`.hashring`: consistent hashing (md5 points, virtual nodes), model
  -> replica, the JAX package's placement key for key;
- :mod:`.router`: the JSONL routing front on one TCP port: hash placement
  with least-loaded spill, health probes (``fleet_replica_healthy
  {replica=}``), one typed re-route on replica loss
  (``resilience.policy.should_reroute``), broadcast ``load`` / ``swap``;
- :mod:`.supervisor`: the replicas' lifecycle: spawn N ``serve`` children
  sharing ONE versioned manifest, respawn any unplanned exit (the child
  restores from the manifest alone), scale by spawn and SIGTERM drain;
  ``python -m xgboost_tpu_torch serve-fleet`` runs supervisor and router
  in one process.

Each replica is a process of its own, on the card unless ``--device cpu``
says otherwise; the supervising process touches no tensor. Fair sharing
between tenants stays in every replica's own path
(``serving.tenancy.TenantFairQueue`` and the ``tenant_quota`` shed).
"""

from .hashring import HashRing  # noqa: F401
from .router import ReplicaEndpoint, Router  # noqa: F401
from .supervisor import FleetSupervisor, serve_fleet_main  # noqa: F401

__all__ = ["FleetSupervisor", "HashRing", "ReplicaEndpoint", "Router",
           "serve_fleet_main"]

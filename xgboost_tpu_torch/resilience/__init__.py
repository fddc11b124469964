"""The failure-handling layer (the port of the JAX package's
``resilience``):

- ``policy``: failure classification (transient / resource / permanent,
  with the card's own signatures), ``RetryPolicy`` (bounded retries,
  deterministic backoff, deadlines; ``XGBTPU_RETRY``) and
  ``should_reroute``, the serving fleet router's verdict on a request
  lost in transit;
- ``chaos``: named-site fault injection with seeded schedules
  (``XGBTPU_CHAOS``);
- ``checkpoint``: atomic, checksummed checkpoints with previous-good
  fallback, behind ``train(..., resume_from=dir)``;
- ``watchdog``: a deadline around collective set-up and each round's
  dispatch (``XGBTPU_WATCHDOG``).

Not ported: the JAX package's ``degrade`` (its callers demote a Pallas
kernel to XLA, a fallback the port forbids: a kernel launches or
raises) and the ``policy.retry_call`` shorthand (the port has no caller
of it).
"""

from . import chaos, checkpoint, policy, watchdog  # noqa: F401
from .chaos import ChaosError  # noqa: F401
from .policy import (  # noqa: F401
    PERMANENT, RESOURCE, TRANSIENT, RetryPolicy, classify,
)
from .watchdog import WatchdogTimeout, watchdog as watchdog_ctx  # noqa: F401

__all__ = [
    "chaos", "checkpoint", "policy", "watchdog",
    "ChaosError", "RetryPolicy", "WatchdogTimeout",
    "classify", "TRANSIENT", "RESOURCE", "PERMANENT",
]

"""Consistent-hash ring: model name -> replica, stable under churn (the
port of the JAX package's ``serving/fleet/hashring.py``, kept point for
point: the same nodes and ``vnodes`` place every key on the same replica
in both packages).

The routing front (``router.py``) concentrates each model's traffic on one
replica, so its arena residency and forest snapshot warm in one place
instead of N. The mapping is:

- **deterministic across processes and restarts**: Python's ``hash()`` is
  seeded per interpreter, so points are placed with md5 (stable and well
  mixed; this is placement, not security). A restarted router computes
  the same ring, and two routers over the same replica set agree without
  coordination;
- **minimally disruptive**: each replica owns ``vnodes`` points (default
  64). Removing a replica frees only its points, so only the models that
  hashed to it remap (to the ring successors); adding it back restores
  the original mapping exactly.

The ring knows nothing of health: :meth:`walk` yields every replica in
ring order from a key's position and the router takes the first healthy
one, so an unhealthy replica's models fail over to stable successors and
fail back when it is healthy again.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterator, List, Sequence, Tuple

__all__ = ["HashRing"]


def _point(label: str) -> int:
    """A stable 64-bit ring position for ``label``."""
    return int.from_bytes(
        hashlib.md5(label.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """A sorted list of (point, node) pairs; not thread-safe (the router
    changes it only under its own lock)."""

    def __init__(self, nodes: Sequence[str] = (), *,
                 vnodes: int = 64) -> None:
        self.vnodes = max(1, int(vnodes))
        self._points: List[Tuple[int, str]] = []
        self._nodes: Dict[str, bool] = {}
        for n in nodes:
            self.add(n)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes[node] = True
        for i in range(self.vnodes):
            bisect.insort(self._points, (_point(f"{node}#{i}"), node))

    def remove(self, node: str) -> None:
        if self._nodes.pop(node, None) is None:
            return
        self._points = [p for p in self._points if p[1] != node]

    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def lookup(self, key: str) -> str:
        """The ring owner of ``key`` (the first point at or after its
        hash, wrapping). Raises ``KeyError`` on an empty ring."""
        for node in self.walk(key):
            return node
        raise KeyError("hash ring is empty")

    def walk(self, key: str) -> Iterator[str]:
        """Every node in ring order from ``key``'s position, each once:
        the failover order, the owner first, then its stable successors."""
        if not self._points:
            return
        idx = bisect.bisect_right(self._points, (_point(key), "\uffff"))
        seen = set()
        n = len(self._points)
        for off in range(n):
            node = self._points[(idx + off) % n][1]
            if node not in seen:
                seen.add(node)
                yield node

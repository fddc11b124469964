"""The work a boosting round needs, counted from its shapes alone.

The counts are of what each function needs, whichever kernel computes it,
so a roofline read from them compares kernel A with kernel D and any
later design on one scale. Each function reads each input byte once and
writes each output byte once; ``ops`` counts the arithmetic it cannot do
without. ``least_s`` is the least time a chip could take: the larger of
bytes over the memory bandwidth and ops over the scalar peak.

- ``level``: one level's histogram of ``n`` rows, ``F`` features and ``B``
  bins at depth ``d``. It reads the ``n * F`` bins once, each at the
  narrowest integer type that holds ``B + 1`` values, the ``n`` gradient
  pairs at 8 bytes and the ``n`` node positions at 4 bytes, and writes the
  ``F * 2^d * B`` (g, h) pairs in float32; it adds ``2 * n * F`` times.
- ``split_search``: reads that histogram, scores ``2 * F * B`` candidate
  splits a node (missing left and right) at 10 operations each, writes a
  32-byte decision a node.
- ``gradient``: the objective's own count, ``work(n, G)`` of its
  reference file (``reference/objectives/<name>.py``); an objective
  without one raises.
- ``partition``: routes each row through the last level: one bin read, a
  position read and written, 1 operation.
- ``leaf_delta``: adds each row's leaf value to its margin: a position
  read, the margin read and written, 1 operation.
- ``eval_walk``: walks ``m`` held-out rows through one tree of depth
  ``D``: one feature value read a level, the margin read and written, and
  the tree's nodes read once at 16 bytes; 3 operations a level.

A round of an objective with ``G`` outputs takes one gradient of ``n``
rows and ``G`` outputs, then grows ``G`` trees: each has its levels,
split searches, partition, margin update and eval walk.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from . import lookup

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    ops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops)


def bin_bytes(B: int) -> int:
    """Bytes of the narrowest integer type holding ``B + 1`` values."""
    for k in (1, 2, 4):
        if B + 1 <= 1 << (8 * k):
            return k
    return 8


def level(n: int, F: int, B: int, d: int) -> Work:
    return Work(n * F * bin_bytes(B) + 8 * n + 4 * n + F * (1 << d) * B * 8,
                2 * n * F)


def split_search(F: int, B: int, d: int) -> Work:
    K = 1 << d
    return Work(F * K * B * 8 + 32 * K, 20 * F * K * B)


def gradient(objective: str, n: int, groups: int = 1) -> Work:
    return lookup.objective(objective).work(n, groups)


def partition(n: int, B: int) -> Work:
    return Work(n * (bin_bytes(B) + 8), n)


def leaf_delta(n: int) -> Work:
    return Work(12 * n, n)


def eval_walk(m: int, depth: int) -> Work:
    return Work(m * (4 * depth + 8) + ((1 << (depth + 1)) - 1) * 16,
                3 * m * depth)


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of the card named ``device_name`` (None for a
    card the table lacks)."""
    with open(_PEAKS) as f:
        table = json.load(f)["cards"]
    for key, row in table.items():
        if key in device_name:
            return row
    return None


def least_s(w: Work, peak: dict) -> float:
    return max(w.bytes / peak["hbm_bytes_per_s"], w.ops / peak["scalar_ops_per_s"])


def level_hist_least_s(n: int, F: int, B: int, depth: int, peak: dict,
                       groups: int = 1) -> float:
    """The least time of a round's level histograms: ``depth`` levels
    of each of its ``groups`` trees."""
    return sum(least_s(level(n, F, B, d), peak)
               for _ in range(groups) for d in range(depth))


def round_least_s(objective: str, n: int, F: int, B: int, depth: int,
                  m_eval: int, peak: dict, groups: int = 1) -> float:
    """The least time of a round: the gradient, then for each of its
    ``groups`` trees the last partition, the margin update, one walk of
    the held-out rows and each level's histogram and split search, each
    part at its own bound."""
    parts = [gradient(objective, n, groups)]
    for _ in range(groups):
        parts += [partition(n, B), leaf_delta(n), eval_walk(m_eval, depth)]
        for d in range(depth):
            parts += [level(n, F, B, d), split_search(F, B, d)]
    return sum(least_s(w, peak) for w in parts)

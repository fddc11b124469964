"""The benchmark's data, driven by a configuration's ``data`` block and a
workload's sizes.

Rows are drawn on the device from ``--seed`` with a ``torch.Generator``,
in a few large calls, then handed to the program as host numpy arrays,
as users pass them. The rule that draws them is the configuration's own
file, ``rules/<data.label>.py`` (``lookup.rule``): ``make_classification``
(scikit-learn's, the reference's benchmark job) or ``grades`` (graded
rows in queries). This module keeps what the rules share.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import lookup


@dataclasses.dataclass
class Split:
    X: np.ndarray  # [n, F] float32, NaN missing
    y: np.ndarray  # [n] float32
    sizes: Optional[np.ndarray]  # [Q] int64 query sizes, or None


@dataclasses.dataclass
class Data:
    train: Split
    valid: Split


def query_sizes(queries: int, rows: int, lo: int, hi: int) -> np.ndarray:
    """``queries`` sizes in [lo, hi] summing to ``rows``, evenly spread."""
    s = lo + (np.arange(queries, dtype=np.int64) * (hi - lo + 1)) // queries
    diff = rows - int(s.sum())
    step = 1 if diff > 0 else -1
    i = 0
    while diff:
        j = i % queries
        if lo <= s[j] + step <= hi:
            s[j] += step
            diff -= step
        i += 1
        if i > 4 * queries * (hi - lo + 1):
            raise ValueError(f"{queries} queries of {lo}-{hi} rows cannot "
                             f"hold {rows} rows")
    return s


def make(config: dict, workload: dict, seed: int, device) -> Data:
    """The training and held-out rows of ``workload`` under ``config``'s
    data rule, drawn from ``seed`` on ``device``."""
    return lookup.rule(config).make(config, workload, seed, device)

"""Numeric debugging dumps (the port of the JAX package's
``utils/observer.py``; reference ``src/common/observer.h:38``).

Set ``XGBTPU_OBSERVER=<dir>`` to turn it on. Each observed array lands in
``<dir>/<iteration:05d>_<name>.npy``, with a one-line summary on stderr,
under the JAX package's names and in its format, so the two packages (or
two versions of one) can be diffed array by array. ``Booster._update``
observes each round's ``margin`` (``[n, K]``), ``grad`` and ``hess``
(``[n]`` for one output group, ``[n, K]`` otherwise); when the variable
is unset it copies nothing off the card.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Optional

import numpy as np

__all__ = ["observe", "enabled"]


def _dir() -> Optional[str]:
    return os.environ.get("XGBTPU_OBSERVER") or None


def enabled() -> bool:
    return _dir() is not None


def observe(name: str, value: Any, iteration: int = 0) -> None:
    """Write ``value`` (a host array) as ``name`` of ``iteration``; a no-op
    unless ``XGBTPU_OBSERVER`` names a directory."""
    d = _dir()
    if d is None:
        return
    os.makedirs(d, exist_ok=True)
    arr = np.asarray(value)
    path = os.path.join(d, f"{iteration:05d}_{name}.npy")
    np.save(path, arr)
    with np.errstate(all="ignore"):
        print(
            f"[observer] it={iteration} {name}: shape={arr.shape} "
            f"sum={float(arr.astype(np.float64).sum()):.9g} "
            f"min={float(arr.min()) if arr.size else 0:.6g} "
            f"max={float(arr.max()) if arr.size else 0:.6g} -> {path}",
            file=sys.stderr,
            flush=True,
        )

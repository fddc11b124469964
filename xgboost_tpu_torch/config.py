"""Process-wide configuration (the port of the JAX package's ``config.py``;
reference ``include/xgboost/global_config.h:17`` and
``python-package/xgboost/config.py``): ``set_config``, ``get_config`` and
``config_context``, per thread, with the JAX package's keys and defaults.

``verbosity`` governs the port's own warnings (``warn``) and the console
logger (``utils.log``): 0 silences them. ``trace_path`` turns span tracing
on (``observability.trace``; the ``XGBTPU_TRACE`` environment variable
wins over it). Two keys change nothing on the card and say so once when
set away from their defaults: ``use_x64`` (the histograms are exact int64
sums and the objectives' transcendentals run in float64 whatever it says)
and ``deterministic_histogram`` (always true: fixed-point int64
histograms). The JAX package's ``apply_debug_env`` maps environment
variables onto ``jax.config`` flags and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Any, Dict, Iterator

__all__ = ["set_config", "get_config", "config_context", "warn"]

_DEFAULTS: Dict[str, Any] = {
    "verbosity": 1,
    "use_x64": False,
    "deterministic_histogram": True,
    "trace_path": None,
}

#: the keys that change nothing, with what the port does instead
_INERT = {
    "use_x64": "histograms are exact int64 sums and the objectives' "
               "transcendentals run in float64 on every device",
    "deterministic_histogram": "histograms are always deterministic "
                               "(fixed-point int64 sums)",
}
_said: set = set()
_local = threading.local()


def _state() -> Dict[str, Any]:
    if not hasattr(_local, "cfg"):
        _local.cfg = dict(_DEFAULTS)
    return _local.cfg


def warn(message: str, stacklevel: int = 2) -> None:
    """``warnings.warn`` unless ``verbosity`` is 0."""
    if _state()["verbosity"] >= 1:
        warnings.warn(message, stacklevel=stacklevel + 1)


def set_config(**kwargs: Any) -> None:
    """Set configuration keys; an unknown key raises ValueError."""
    cfg = _state()
    for k in kwargs:
        if k not in cfg:
            raise ValueError(f"Unknown global config key: {k}")
    cfg.update(kwargs)
    for k, v in kwargs.items():
        if k in _INERT and v != _DEFAULTS[k] and k not in _said:
            _said.add(k)
            warn(f"{k}={v!r} changes nothing on this port: {_INERT[k]}")


def get_config() -> Dict[str, Any]:
    return dict(_state())


@contextlib.contextmanager
def config_context(**kwargs: Any) -> Iterator[None]:
    """Set keys for the ``with`` block; the previous values come back on
    exit, also after an exception."""
    saved = get_config()
    set_config(**kwargs)
    try:
        yield
    finally:
        _state().update(saved)

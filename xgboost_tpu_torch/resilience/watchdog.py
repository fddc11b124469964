"""Deadline watchdog: abort a wedged host dispatch instead of hanging the
run (the port of the JAX package's ``resilience/watchdog.py``).

``watchdog(site, seconds)`` arms a daemon timer around the guarded block.
On expiry it interrupts the main thread, then records
``watchdog_timeouts_total{site}``, a trace instant, a flight event and the
flight recorder's black box (``RECORDER.dump``), and runs the caller's
``on_timeout``; the block raises ``WatchdogTimeout``, so ``train`` commits
its finished rounds and exits with a real error.

**The limit on the card.** ``_thread.interrupt_main`` lands only at a
bytecode boundary of the main thread. A main thread blocked in
``torch.cuda.synchronize()``, in a kernel wrapper's synchronisation (a
``.item()`` or ``.cpu()`` of a result), or inside a gloo collective sees
the timeout only when that call returns. The watchdog cannot stop a
kernel that is running: it stops the Python loop around the kernels.

Deadlines come from ``XGBTPU_WATCHDOG`` (bare seconds, or
``site=S,*=S``) or the call site's default; 0 or unset means none. Only
the main thread can be guarded; elsewhere the context manager does
nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Iterator, Optional

__all__ = ["WatchdogTimeout", "watchdog", "deadline_for"]

_ENV = "XGBTPU_WATCHDOG"


class WatchdogTimeout(RuntimeError):
    """A guarded block exceeded its deadline."""

    def __init__(self, site: str, seconds: float):
        super().__init__(
            f"watchdog: {site!r} exceeded its {seconds:g}s deadline "
            f"({_ENV}); aborting instead of wedging")
        self.site = site
        self.seconds = seconds


def deadline_for(site: str, default: Optional[float] = None
                 ) -> Optional[float]:
    """Deadline seconds for ``site`` per ``XGBTPU_WATCHDOG`` (a bare float
    or ``site=S,*=S``), else ``default``. <= 0 disables."""
    raw = os.environ.get(_ENV)
    if not raw:
        return default
    fallback = default
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
        else:
            k, v = "*", part
        try:
            fv = float(v)
        except ValueError:
            continue  # a malformed variable must never break training
        if k == site:
            return fv
        if k == "*":
            fallback = fv
    return fallback


@contextlib.contextmanager
def watchdog(site: str, seconds: Optional[float] = None,
             on_timeout: Optional[Callable[[], None]] = None
             ) -> Iterator[None]:
    """Guard the block with a ``seconds`` deadline (default: the variable's
    for ``site``). Raises ``WatchdogTimeout`` when it expires."""
    if seconds is None:
        seconds = deadline_for(site)
    if (not seconds or seconds <= 0
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    fired = threading.Event()
    handled = threading.Event()

    def _expire() -> None:
        import _thread

        # interrupt right after setting the flag: work between the two
        # widens the window in which the block exits and the interrupt
        # lands somewhere later
        fired.set()
        _thread.interrupt_main()
        try:  # telemetry after the abort is in flight
            from ..observability import flight, trace
            from ..observability.metrics import REGISTRY
            from ..utils import console_logger

            REGISTRY.counter(
                "watchdog_timeouts_total",
                "Deadline expiries by watchdogged site",
            ).labels(site=site).inc()
            trace.instant("watchdog_timeout", site=site, seconds=seconds)
            # the black box from this thread: the main thread may never
            # reach train()'s abort handler
            flight.RECORDER.event("watchdog_timeout", site=site,
                                  seconds=seconds)
            flight.RECORDER.dump(f"watchdog:{site}")
            console_logger.warning(
                f"watchdog: {site!r} still running after {seconds:g}s; "
                "interrupting the main thread")
            if on_timeout is not None:
                on_timeout()
        except Exception:
            pass
        finally:
            handled.set()

    timer = threading.Timer(seconds, _expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    except KeyboardInterrupt:
        if fired.is_set():
            handled.wait(5.0)
            raise WatchdogTimeout(site, seconds) from None
        raise  # a real Ctrl-C stays one
    finally:
        timer.cancel()
        if fired.is_set():
            # the timer fired but the interrupt may not have landed yet:
            # give it a bytecode boundary, swallow it, raise below
            try:
                time.sleep(0.05)
            except KeyboardInterrupt:
                pass
    if fired.is_set():
        handled.wait(5.0)
        raise WatchdogTimeout(site, seconds)

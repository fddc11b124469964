"""The arithmetic behind the metric readers in ``metrics/``.

Each reader takes a ``harness.Run`` and returns a number, or None where
the run has nothing to read (an untraced run, a card the peak table
lacks, a window too short for a sampled round): the harness then leaves
the metric out of the line. A share of a roofline or of a peak is never
made up as 0.
"""

from __future__ import annotations

from typing import Optional

from . import work


def round_ms(run) -> Optional[float]:
    """All the window's time over all the rounds it completed, in ms."""
    if run.window_rounds <= 0:
        return None
    return run.window_s / run.window_rounds * 1e3


def setup_s(run) -> float:
    return run.setup_s


def ingest_s(run) -> float:
    return run.ingest_s


def level_update_ms(run) -> Optional[float]:
    """The grow profiler's host-blocked ms of ``level_update`` summed over
    a round's depths, the mean over the sampled rounds."""
    per_round = [sum(op["host_s"] for op in d["ops"] if op["op"] == "level_update")
                 for d in run.grow_details]
    if not per_round:
        return None
    return sum(per_round) / len(per_round) * 1e3


def _peak(run):
    return work.peaks(run.device_name) if run.profile is not None else None


def level_hist_roofline(run) -> Optional[float]:
    """The level histograms' least time over their launches' device time
    in the profiled rounds (``groups`` trees a round), in %."""
    peak = _peak(run)
    if peak is None or run.profile["level_hist_s"] <= 0:
        return None
    s = run.shapes
    least = work.level_hist_least_s(s["n"], s["F"], s["B"], s["depth"], peak,
                                    s["groups"])
    return 100.0 * least * run.profile["rounds"] / run.profile["level_hist_s"]


def plain_round_s(run) -> Optional[float]:
    """The traced run's time a round at the program's own pace: its window
    less the rounds a profiler watched, over the rounds left."""
    if run.plain is None or run.plain[1] <= 0:
        return None
    return run.plain[0] / run.plain[1]


def idle_share(run) -> Optional[float]:
    """The share of a round at the program's own pace in which the device
    ran nothing, in %: 1 - the profiled rounds' device busy time a round
    (the union of their device activity) over ``plain_round_s``. The
    profiler slows the host's rounds, not the device's work, so its own
    window would read the profiler's pace."""
    t = plain_round_s(run)
    if run.profile is None or t is None:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["rounds"] / t)


def round_mfu(run) -> Optional[float]:
    """A round's least time at the card's peaks over ``plain_round_s``, in %."""
    peak = _peak(run)
    t = plain_round_s(run)
    if peak is None or t is None:
        return None
    s = run.shapes
    least = work.round_least_s(s["objective"], s["n"], s["F"], s["B"], s["depth"],
                               s["m_eval"], peak, s["groups"])
    return 100.0 * least / t

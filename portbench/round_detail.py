"""The readers of the program's ``round_detail`` records.

On the grow profiler's sampled rounds (``harness.GROW_PROFILED_ROUNDS``)
the program annotates its flight round record with ``round_detail``
(``xgboost_tpu_torch/observability/kernelprof.py``): buckets of
``_level_update``'s sub-ops at their depth (``level_update/scan``: the
strict-order scans) and of the round's ops outside the grower at depth -1
(``gradient``, ``eval_walk``, ``eval_metric``). The harness keeps them as
the run's ``round_details`` (``records``, from the program's flight
recorder, beside ``grow_details``); each reader takes them from the run
it is given and returns None where no sampled round carries the op: an
untraced run, or a program without the record.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def records() -> List[Dict]:
    """The ``round_detail`` records of this process's sampled rounds."""
    from xgboost_tpu_torch.observability import flight

    return [r["round_detail"] for r in flight.RECORDER.records()
            if r.get("t") == "round" and "round_detail" in r]


def mean_ms(details: List[Dict], op: str, field: str) -> Optional[float]:
    """``field`` of ``op``'s buckets summed over a round's depths, the mean
    over the rounds that ran it, in ms."""
    per_round = [sum(b[field] for b in d["ops"] if b["op"] == op)
                 for d in details if any(b["op"] == op for b in d["ops"])]
    if not per_round:
        return None
    return sum(per_round) / len(per_round) * 1e3


def level_scan_ms(run) -> Optional[float]:
    """Host ms of the strict-order scans inside ``_level_update`` a round
    (host-only brackets: no sync; part of ``level_update_ms``)."""
    return mean_ms(run.round_details, "level_update/scan", "host_s")


def gradient_ms(run) -> Optional[float]:
    """Ms of the round's margin read and ``get_gradient``, bracketed by
    syncs."""
    return mean_ms(run.round_details, "gradient", "wall_s")


def eval_walk_ms(run) -> Optional[float]:
    """Ms of the held-out rows' walk (kernel B) into the eval cache."""
    return mean_ms(run.round_details, "eval_walk", "wall_s")


def eval_metric_ms(run) -> Optional[float]:
    """Ms of ``eval_transform`` and every metric down to its float."""
    return mean_ms(run.round_details, "eval_metric", "wall_s")

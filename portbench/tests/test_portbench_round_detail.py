"""The readers of the program's ``round_detail`` records, on the CPU.

Run: ``python -m pytest portbench/tests -q``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, round_detail  # noqa: E402

METRICS = ("level_scan_ms", "gradient_ms", "eval_walk_ms", "eval_metric_ms")


def _rec(round_idx, scale):
    def b(op, depth, host, inflight=0.0, **kw):
        return dict(op=op, depth=depth, impl="torch", count=1, wall_s=host + inflight,
                    host_s=host, inflight_s=inflight, gap_s=0.0, **kw)

    ops = [b("gradient", -1, 0.001 * scale, 0.002 * scale),
           b("eval_walk", -1, 0.0005 * scale, 0.001 * scale),
           b("eval_metric", -1, 0.003 * scale)]
    for d in range(3):
        ops += [b("level_update/scan", d, 0.004 * scale, steps=512),
                b("level_update/with_missing", d, 0.003 * scale)]
    return {"round": round_idx, "trees": 1, "ops": ops}


def _run(details):
    return harness.Run(shapes={}, device_name="", setup_s=0, ingest_s=0, window_s=1,
                       window_rounds=1, round_details=details)


def test_readers_take_the_mean_over_sampled_rounds():
    details = [_rec(8, 1.0), _rec(10, 2.0)]
    run = _run(details)
    assert round_detail.level_scan_ms(run) == pytest.approx(3 * 4.0 * 1.5)
    assert round_detail.gradient_ms(run) == pytest.approx(3.0 * 1.5)
    assert round_detail.eval_walk_ms(run) == pytest.approx(1.5 * 1.5)
    assert round_detail.eval_metric_ms(run) == pytest.approx(3.0 * 1.5)
    # a round without the op (an uncovered round) is left out of the mean
    details.append({"round": 12, "trees": 0, "ops": []})
    assert round_detail.gradient_ms(run) == pytest.approx(3.0 * 1.5)


@pytest.mark.parametrize("suffix", ["binary", "rank"])
@pytest.mark.parametrize("name", METRICS)
def test_a_run_without_round_detail_reports_nothing(name, suffix):
    """An untraced run, or a program that writes no ``round_detail``: the
    reader returns None and the harness leaves the metric out."""
    from xgboost_tpu_torch.observability import RECORDER

    RECORDER.reset()
    RECORDER.begin_round(8)
    RECORDER.annotate("grow_detail", {"ops": []})
    RECORDER.end_round()
    try:
        assert round_detail.records() == []
        assert harness.reader(f"{name}.{suffix}")(_run(round_detail.records())) is None
    finally:
        RECORDER.reset()


def test_readers_read_the_programs_flight_records():
    """The harness keeps the process's sampled ``round_detail`` records as
    the run's ``round_details``; the readers read the run they are given."""
    from xgboost_tpu_torch.observability import RECORDER

    RECORDER.reset()
    try:
        for i, scale in ((8, 1.0), (10, 3.0)):
            RECORDER.begin_round(i)
            RECORDER.annotate("round_detail", _rec(i, scale))
            RECORDER.end_round()
        RECORDER.begin_round(11)  # an unsampled round between them
        RECORDER.end_round()
        run = _run(round_detail.records())
        assert len(run.round_details) == 2
        RECORDER.reset()  # the run keeps its own records
        assert harness.reader("level_scan_ms.binary")(run) == pytest.approx(24.0)
        assert harness.reader("eval_walk_ms.rank")(run) == pytest.approx(3.0)
        assert harness.reader("eval_walk_ms.rank")(_run([])) is None
    finally:
        RECORDER.reset()

"""The check must fail the control and every fault a cell can have.

A run of each cell at a size the CPU holds, with a fault of ``faults.py``
planted in the program underneath the harness (the harness's look for a
card skipped), comes out not correct; so does the control (the reference
in bfloat16, ``control.py``). The exchange between cards is no fault a
one-card cell can have.

Run: ``python -m pytest portbench/tests -q``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, faults, harness, judge, traffic  # noqa: E402

SMALL = {
    "synth-binary.1m-bin256": {"rows": 6000, "eval_rows": 2000},
    "mslr-ndcg.web10k": {"rows": 9000, "queries": 75, "eval_rows": 2400,
                         "eval_queries": 20},
}


@pytest.fixture
def sampled_pairs(monkeypatch):
    """The port's sampled ranking pairs at the tests' small sizes (the
    cells' sizes are past its all-pairs budget)."""
    from xgboost_tpu_torch.objective import ranking

    monkeypatch.setattr(ranking, "_ALL_PAIRS_BUDGET", 16)


def _run(name):
    return harness.run_cell(name, 2**31 + 77, 0.3, False, "cpu", overrides=SMALL[name],
                            log=lambda m: None)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name, sampled_pairs):
    r = _run(name)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_planted_fault_fails_the_check(name, fault, sampled_pairs):
    with faults.FAULTS[fault]():
        r = _run(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_the_check(name):
    c = harness.cell(name)
    c["traffic"].update(SMALL[name])
    params = harness.params_of(c)
    data = traffic.make(c["config"], c["traffic"], 2**31 + 78, "cpu")
    out = control.outputs(data, params, 3, "cpu")
    checks = judge.compare(out, data, params, 3, 2**31 + 78, "cpu")
    ok, failed = judge.verdict(checks, c["traffic"]["limits"])
    assert not ok and failed, checks

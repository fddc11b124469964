"""The port's banked perf ledger (``xgboost_tpu_torch.observability.ledger``)
against the JAX package's ``observability/ledger.py``.

- ``parse_metric`` and ``validate_record`` give equal answers over one
  list of names and records (well-formed, marked, extrapolated, foreign,
  malformed);
- a bank written by either package's ``write_bank`` is byte-equal to the
  other's and loads through the other's ``load_bank_file`` to the same
  records; both refuse the same bad records with the same message and
  leave no file;
- legacy (the predict line recovered from ``tail``), failed
  (``parsed: null``) and torn banks load as the JAX package loads them;
- ``perf-report``'s text and ``--json`` equal the JAX package's on
  synthetic banks and on the repository's own ``BENCH_r*.json`` with
  ``BASELINE.json`` (read only), and the command line routes to it.
"""

import json
import math
import os

import pytest

from xgboost_tpu.observability import ledger as jl
from xgboost_tpu_torch.observability import ledger as tl

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

NAMES = [
    "train_time_1000kx50_500r_depth6_bin64",
    "train_time_1000kx50_500r_depth6",
    "train_time_1000kx50_500r_depth6_cpu_fallback_extrapolated_from_24r",
    "train_time_1000kx50_500r_depth6_bin64_extrapolated_from_400r",
    "train_time_100kx50_10r_depth6_bin64_quality_failed",
    "train_time_100kx50_10r_depth6_parity_failed_cpu_fallback",
    "predict_inplace_100kx50_10r",
    "predict_inplace_100kx50_10r_cpu_fallback",
    "train_time_failed",
    "not_a_metric",
    "Train_time_1kx2",
    "",
    None,
    42,
]


def _train_rec(**kw):
    rec = {"metric": "train_time_100kx50_10r_depth6_bin64", "value": 12.5,
           "unit": "s", "vs_baseline": 0.25,
           "stages": {"grow": 10.0, "predict": 1.5},
           "dispatch": {"level_hist": "cuda:D", "level_update": "torch"}}
    rec.update(kw)
    return rec


_PREDICT = {"metric": "predict_inplace_100kx50_10r", "value": 1e6,
            "unit": "rows/s"}

RECORDS = [
    _train_rec(),
    _train_rec(value=float("nan"), unit=""),
    _train_rec(value=-1.0),
    _train_rec(value=True),
    _train_rec(vs_baseline="fast"),
    {k: v for k, v in _train_rec().items() if k != "stages"},
    {k: v for k, v in _train_rec().items() if k != "dispatch"},
    {k: v for k, v in _train_rec().items() if k != "vs_baseline"},
    _train_rec(stages={}),
    _train_rec(stages={"grow": float("inf")}),
    _train_rec(dispatch={"level_hist": 3}),
    _train_rec(metric="train_time_failed"),
    _PREDICT,
    [],
    "record",
]


@pytest.mark.parametrize("name", NAMES)
def test_parse_metric_matches_jax(name):
    assert tl.parse_metric(name) == jl.parse_metric(name)


def test_parse_metric_reads_the_grammar():
    f = tl.parse_metric(NAMES[2])
    assert (f["family"], f["shape"], f["rows"], f["cols"], f["rounds"]) \
        == ("train_time", "1000kx50", 1_000_000, 50, 500)
    assert f["markers"] == ["cpu_fallback", "extrapolated_from_24r"]
    assert f["measured_rounds"] == 24
    assert tl.SCHEMA == jl.SCHEMA == "bench-bank-v1"


@pytest.mark.parametrize("i", range(len(RECORDS)))
@pytest.mark.parametrize("stages", [False, True])
def test_validate_record_matches_jax(i, stages):
    rec = RECORDS[i]
    got = tl.validate_record(rec, require_stages=stages)
    assert got == jl.validate_record(rec, require_stages=stages)
    if i == 0:
        assert got == []


@pytest.mark.parametrize("writer, reader", [(tl, jl), (jl, tl)])
def test_bank_written_by_one_package_loads_in_the_other(writer, reader,
                                                        tmp_path):
    recs = [_train_rec(), _PREDICT]
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    path = writer.write_bank(str(a), 7, "bench --bank r07", 0, recs)
    other = reader.write_bank(str(b), 7, "bench --bank r07", 0, recs)
    assert os.path.basename(path) == os.path.basename(other) == \
        "BENCH_r07.json"
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    got = reader.load_bank_file(path)
    assert got == writer.load_bank_file(path)
    assert got["n"] == 7 and got["records"] == recs
    doc = json.load(open(path))
    assert doc["schema"] == reader.SCHEMA and doc["parsed"] == recs[0]
    assert sorted(os.listdir(a)) == ["BENCH_r07.json"]  # no .tmp left


@pytest.mark.parametrize("records", [
    [], [{k: v for k, v in _train_rec().items() if k != "dispatch"}],
    [_train_rec(), _train_rec(value=math.nan)], ["line"]])
def test_write_bank_refuses_what_jax_refuses(records, tmp_path):
    msgs = []
    for pkg in (tl, jl):
        with pytest.raises(ValueError) as exc:
            pkg.write_bank(str(tmp_path), 16, "cmd", 0, records)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert not os.listdir(tmp_path)


def _legacy_failed_torn(root):
    legacy = {
        "n": 5, "cmd": "python bench.py", "rc": 0,
        "tail": "noise\n"
        + json.dumps({"metric": "train_time_1000kx50_500r_depth6",
                      "value": 79.0, "unit": "s"}) + "\n"
        + json.dumps(_PREDICT) + "\n"
        + "{torn json\n",
        "parsed": {"metric": "train_time_1000kx50_500r_depth6",
                   "value": 79.0, "unit": "s"},
    }
    (root / "BENCH_r05.json").write_text(json.dumps(legacy))
    (root / "BENCH_r01.json").write_text(json.dumps(
        {"n": 1, "rc": 1, "tail": "boom", "parsed": None}))
    (root / "BENCH_r03.json").write_text("{not json")
    (root / "BENCH_r9.json").write_text(json.dumps(
        {"rc": 0, "lines": [_train_rec(value=20.0)]}))  # n from the name


def test_legacy_failed_and_torn_banks_load_as_jax_loads_them(tmp_path,
                                                             capsys):
    _legacy_failed_torn(tmp_path)
    for name in ("BENCH_r05.json", "BENCH_r01.json", "BENCH_r9.json"):
        path = str(tmp_path / name)
        assert tl.load_bank_file(path) == jl.load_bank_file(path)
    mine = tl.load_ledger(str(tmp_path))
    err_mine = capsys.readouterr().err
    theirs = jl.load_ledger(str(tmp_path))
    assert mine == theirs and capsys.readouterr().err == err_mine
    assert [b["n"] for b in mine] == [1, 5, 9]
    assert "unreadable bank" in err_mine and "BENCH_r03.json" in err_mine
    assert mine[0]["records"] == []  # the failed bank: zero records
    # parsed and its tail copy are ONE record; the predict line comes
    # from the tail
    assert [r["metric"] for r in mine[1]["records"]] == [
        "train_time_1000kx50_500r_depth6", "predict_inplace_100kx50_10r"]


def _both_mains(argv, capsys):
    out = []
    for pkg in (tl, jl):
        rc = pkg.main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_perf_report_matches_jax_on_synthetic_banks(tmp_path, capsys):
    tl.write_bank(str(tmp_path), 10, "c", 0, [_train_rec(), _PREDICT])
    jl.write_bank(str(tmp_path), 11, "c", 0, [_train_rec(
        value=50.0,
        metric="train_time_100kx50_10r_depth6_bin64_quality_failed")])
    tl.write_bank(str(tmp_path), 14, "c", 0, [_train_rec(value=10.0)])
    _legacy_failed_torn(tmp_path)
    (tmp_path / "BASELINE.json").write_text(json.dumps(
        {"published": {"hist_1000kx50": {"seconds": 36.01,
                                         "hardware": "8 cores"}}}))
    for argv in (["--root", str(tmp_path)],
                 ["--root", str(tmp_path), "--json"]):
        (trc, tout, terr), (jrc, jout, jerr) = _both_mains(argv, capsys)
        assert (trc, tout, terr) == (jrc, jout, jerr)
        assert trc == 0
    (_, text, _), _ = _both_mains(["--root", str(tmp_path)], capsys)
    assert "unbanked rounds (no BENCH file): r02-r04, r06-r08, r12-r13" \
        in text
    assert "failed banks (rc!=0, no parsed record): r01" in text
    assert "[quality_failed]" in text and "best" in text
    assert "dispatch: level_hist=cuda:D,level_update=torch" in text
    assert "published reference anchors (BASELINE.json):" in text


def test_perf_report_matches_jax_on_the_repos_banks(capsys):
    """Read only: the repository's own banks and BASELINE.json."""
    before = sorted(os.listdir(REPO))
    for argv in (["--root", REPO], ["--root", REPO, "--json"]):
        (trc, tout, terr), (jrc, jout, jerr) = _both_mains(argv, capsys)
        assert (trc, tout, terr) == (jrc, jout, jerr)
        assert trc == 0
    (_, text, _), _ = _both_mains(["--root", REPO], capsys)
    assert text.startswith("== perf ledger:") and "r15" in text
    assert "published reference anchors" in text
    assert sorted(os.listdir(REPO)) == before


def test_perf_report_usage_and_empty_root(tmp_path, capsys):
    for argv in (["--root", str(tmp_path)], ["--bogus"], ["--root"],
                 ["--help"]):
        (trc, tout, terr), (jrc, jout, jerr) = _both_mains(argv, capsys)
        assert (trc, tout) == (jrc, jout), argv
        assert terr.replace("xgboost_tpu_torch", "xgboost_tpu") == jerr
    from xgboost_tpu_torch import cli as tcli
    assert tcli.cli_main(["perf-report", "--root", str(tmp_path)]) == 1
    assert "no BENCH_r" in capsys.readouterr().err
    assert tcli.cli_main(["perf-report", "--root", REPO, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["banked"] == [b["n"] for b in jl.load_ledger(REPO)]

"""The port's command line (``xgboost_tpu_torch/cli.py``,
``python -m xgboost_tpu_torch``) held against the JAX package's.

- the config-file tasks on a synthetic libsvm file (1500 x 8, a held-out
  file of 400 rows, ``binary:logistic``, depth 3, ``max_bin`` 16, 5
  rounds, ``device=cpu``): ``train`` gives trees equal to the JAX CLI's
  (structure and split conditions exact, leaf values within 1e-5 and loss
  changes within rtol 1e-5, the parity tolerances of
  ``tests/test_torch_training.py``); ``dump`` of one model file writes the
  JAX CLI's text, with and without statistics; ``pred`` of one model file
  writes predictions within 1e-6 of the JAX CLI's; ``save_period`` and
  ``model_in`` (continued training) as in the JAX CLI;
- ``checkpoint-inspect`` prints the JAX package's lines on a directory
  whose newest checkpoint is corrupted, its ``--json`` form the same
  document, and returns 1 on an empty directory;
- ``python -m xgboost_tpu_torch`` without arguments prints the usage and
  returns 1; every JAX subcommand that is not in the port (``lint`` and
  ``dispatch-report``) returns 1 and calls nothing; ``serve-report``,
  ``serve-fleet``, ``perf-report`` and ``grow-report`` run the port's
  ``observability/serve_report.py``, ``serving/fleet/supervisor.py``,
  ``observability/ledger.py`` and ``observability/kernelprof.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from xgboost_tpu import cli as jcli

import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch import cli as tcli

ROOT = Path(__file__).resolve().parent.parent
N, NV, F = 1500, 400, 8
PARAMS = ("objective=binary:logistic\nmax_depth=3\neta=0.3\nmax_bin=16\n"
          "num_round=5\nsilent=1\ndevice=cpu\n")


def _write_libsvm(path, X, y):
    with open(path, "w") as f:
        for row, label in zip(X, y):
            cols = " ".join(f"{j}:{v:.6g}" for j, v in enumerate(row)
                            if not np.isnan(v))
            f.write(f"{int(label)} {cols}\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(11)
    X = rng.randn(N + NV, F).astype(np.float32)
    X[rng.rand(*X.shape) < 0.1] = np.nan
    y = (np.nan_to_num(X) @ rng.randn(F) + 0.3 * rng.randn(N + NV) > 0)
    _write_libsvm(d / "train.libsvm", X[:N], y[:N])
    _write_libsvm(d / "test.libsvm", X[N:], y[N:])
    return d


def _conf(d, name, body):
    path = d / name
    path.write_text(body)
    return str(path)


def _trees(path):
    return json.loads(Path(path).read_text())["learner"][
        "gradient_booster"]["model"]["trees"]


def _assert_same_trees(jt, tt):
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        internal = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[internal],
            np.asarray(b["split_conditions"], np.float32)[internal])
        np.testing.assert_allclose(b["base_weights"], a["base_weights"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(b["loss_changes"])[internal],
                                   np.asarray(a["loss_changes"])[internal],
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def trained(files):
    """Both CLIs' ``train`` task on the same config: the model paths."""
    out = {}
    for tag, main in (("jax", jcli.cli_main), ("port", tcli.cli_main)):
        conf = _conf(files, f"train_{tag}.conf",
                     f"task=train\ndata={files}/train.libsvm\n"
                     f"eval[test]={files}/test.libsvm\n"
                     f"model_out={files}/{tag}.json\n" + PARAMS)
        assert main([conf]) == 0
        out[tag] = files / f"{tag}.json"
    return out


def test_train_task_matches_the_jax_cli(trained):
    _assert_same_trees(_trees(trained["jax"]), _trees(trained["port"]))


@pytest.mark.parametrize("with_stats", [0, 1])
def test_dump_task_writes_the_jax_text(files, trained, with_stats):
    got = {}
    for tag, main in (("jax", jcli.cli_main), ("port", tcli.cli_main)):
        conf = _conf(files, f"dump_{tag}.conf",
                     f"task=dump\nmodel_in={trained['jax']}\n"
                     f"name_dump={files}/dump_{tag}.txt\n"
                     f"with_stats={with_stats}\n" + PARAMS)
        assert main([conf]) == 0
        got[tag] = (files / f"dump_{tag}.txt").read_text()
    assert got["port"] == got["jax"] and "booster[4]" in got["port"]


def test_pred_task_matches_the_jax_cli(files, trained):
    got = {}
    for tag, main in (("jax", jcli.cli_main), ("port", tcli.cli_main)):
        conf = _conf(files, f"pred_{tag}.conf",
                     f"task=pred\nmodel_in={trained['jax']}\n"
                     f"test:data={files}/test.libsvm\n"
                     f"name_pred={files}/pred_{tag}.txt\n" + PARAMS)
        assert main([conf]) == 0
        got[tag] = np.loadtxt(files / f"pred_{tag}.txt")
    assert got["port"].shape == (NV,)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=0, atol=1e-6)
    # the port's own model predicts what its Booster does
    bst = xgbt.Booster(model_file=str(trained["port"]), device="cpu")
    want = bst.predict(xgbt.DMatrix(f"{files}/test.libsvm", device="cpu"))
    conf = _conf(files, "pred_own.conf",
                 f"task=pred\nmodel_in={trained['port']}\n"
                 f"test:data={files}/test.libsvm\n"
                 f"name_pred={files}/pred_own.txt\n" + PARAMS)
    assert tcli.cli_main([conf]) == 0
    np.testing.assert_allclose(np.loadtxt(files / "pred_own.txt"), want,
                               rtol=1e-8, atol=0)


def test_save_period_and_model_in_match_the_jax_cli(files, trained):
    for tag, main in (("jax", jcli.cli_main), ("port", tcli.cli_main)):
        mdir = files / f"periodic_{tag}"
        mdir.mkdir()
        conf = _conf(files, f"periodic_{tag}.conf",
                     f"task=train\ndata={files}/train.libsvm\n"
                     f"model_dir={mdir}\nsave_period=2\n"
                     f"model_in={trained[tag]}\n"
                     f"model_out={files}/cont_{tag}.json\n" + PARAMS)
        assert main([conf]) == 0
        # every second round of the continued run, numbered from its start
        assert sorted(os.listdir(mdir)) == ["_6.json", "_8.json"]
    jt, tt = _trees(files / "cont_jax.json"), _trees(files / "cont_port.json")
    assert len(tt) == 10
    _assert_same_trees(jt, tt)


def test_checkpoint_inspect_matches_the_jax_cli(tmp_path, capsys):
    from xgboost_tpu_torch.resilience.checkpoint import list_checkpoints

    rng = np.random.RandomState(0)
    X = rng.randn(400, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    ck = str(tmp_path / "ck")
    xgbt.train({"max_depth": 2}, xgbt.DMatrix(X, y, device="cpu"), 3,
               verbose_eval=False, resume_from=ck)
    newest = list_checkpoints(ck)[-1]
    with open(newest, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x00")
    for argv in ([ck], [ck, "--json"]):
        assert jcli.cli_main(["checkpoint-inspect"] + argv) == 0
        want = capsys.readouterr().out
        assert tcli.cli_main(["checkpoint-inspect"] + argv) == 0
        got = capsys.readouterr().out
        assert got == want
    lines = _inspect_lines(ck, capsys)
    assert any("CORRUPT" in ln and "ckpt_00000003" in ln for ln in lines)
    assert any(ln.startswith("*") and "ckpt_00000002" in ln
               and "verified" in ln for ln in lines)
    assert json.loads(got)["newest_verified_rounds"] == 2
    empty = str(tmp_path / "nothing")
    assert tcli.cli_main(["checkpoint-inspect", empty]) == 1
    assert jcli.cli_main(["checkpoint-inspect", empty]) == 1


def _inspect_lines(ck, capsys):
    assert tcli.cli_main(["checkpoint-inspect", ck]) == 0
    return capsys.readouterr().out.splitlines()


def test_module_without_arguments_prints_the_usage():
    out = subprocess.run([sys.executable, "-m", "xgboost_tpu_torch"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1
    assert "python -m xgboost_tpu_torch <config>" in out.stderr


@pytest.mark.parametrize("sub", tcli.NOT_PORTED)
def test_unported_subcommand_returns_1(sub, capsys, monkeypatch):
    monkeypatch.setattr(tcli, "parse_config_file", lambda *a: pytest.fail(
        "an unported subcommand read a config"))
    assert tcli.cli_main([sub, "--help"]) == 1
    assert "not in the PyTorch port" in capsys.readouterr().err


def test_not_ported_is_the_four_analysis_tools():
    # perf-report and grow-report are ported (ledger.py, kernelprof.py);
    # the JAX package's own tooling stays out by design
    assert tcli.NOT_PORTED == ("lint", "dispatch-report")


@pytest.mark.parametrize("sub, module, fn", [
    ("serve-report", "xgboost_tpu_torch.observability.serve_report",
     "main"),
    ("serve-fleet", "xgboost_tpu_torch.serving.fleet.supervisor",
     "serve_fleet_main"),
    ("perf-report", "xgboost_tpu_torch.observability.ledger", "main"),
    ("grow-report", "xgboost_tpu_torch.observability.kernelprof", "main"),
])
def test_serving_subcommand_runs_the_ports_tool(sub, module, fn,
                                                monkeypatch):
    import importlib

    seen = []
    monkeypatch.setattr(importlib.import_module(module), fn,
                        lambda argv: seen.append(argv) or 0)
    assert tcli.cli_main([sub, "a", "--b"]) == 0
    assert seen == [["a", "--b"]]


def test_serve_report_on_a_servers_run_dir(tmp_path, capsys):
    from xgboost_tpu_torch.serving import ModelServer

    X = np.random.RandomState(7).randn(200, 4).astype(np.float32)
    bst = xgbt.train({"max_depth": 2}, xgbt.DMatrix(
        X, (X[:, 0] > 0).astype(np.float32), device="cpu"), 2)
    srv = ModelServer(device="cpu", batch_wait_us=0, run_dir=str(tmp_path))
    try:
        srv.load("m", bst)
        for i in range(3):
            srv.predict("m", X[i:i + 2], request_id=f"r{i}", timeout=60)
    finally:
        srv.close()
    assert tcli.cli_main(["serve-report", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("serve-report: 3 request(s)")
    assert os.path.exists(tmp_path / "obs" / "serve_report.json")
    assert tcli.cli_main(["serve-fleet", "--port", "1"]) == 1
    assert "serve-fleet needs --port N and --run-dir D" \
        in capsys.readouterr().err

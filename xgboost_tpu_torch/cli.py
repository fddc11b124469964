"""The command line: config-file tasks ``train`` | ``dump`` | ``pred`` and
the telemetry tools (the port of the JAX package's ``cli.py``; reference
``src/cli_main.cc``, CLITask :30-35, CLIParam :37, and the key=value
parser of ``src/common/config.h``). Usage:

    python -m xgboost_tpu_torch <config> [key=value ...]
    python -m xgboost_tpu_torch trace-report <trace-file|glob> ... [--top N]
    python -m xgboost_tpu_torch obs-report <run_dir> ... [--top-rounds N]
    python -m xgboost_tpu_torch serve-report <run_dir> ... [--top N]
    python -m xgboost_tpu_torch checkpoint-inspect <dir> [--json]
    python -m xgboost_tpu_torch grow-report <flight.jsonl|run-dir> [--round N] | --diff <A> <B>
    python -m xgboost_tpu_torch perf-report [--root DIR] [--json]
    python -m xgboost_tpu_torch serve (--port N | --stdin) [--model name=path ...] [--device cpu]
    python -m xgboost_tpu_torch serve-fleet --port N --run-dir D [--replicas K] [--model name=path ...] [--device cpu]
    python -m xgboost_tpu_torch deliver --connect HOST:PORT (--model M --watch DIR | --status | --stop --model M)

Config keys are the reference's: task, data, test:data, model_in,
model_out, model_dir, num_round, save_period, eval[name]=path,
dump_format, name_pred, name_dump, name_fmap / fmap, with_stats,
iteration_begin, iteration_end, silent; every other key is a booster or
learner parameter. ``device=cpu`` builds the matrices and the booster on
the CPU; without it they go on the CUDA card, and without a card the task
raises. ``trace-report`` summarizes Chrome trace-event files
(``observability/report.py``); ``obs-report`` merges a run's per-rank
telemetry (``run_dir/obs/rank<k>/``) into one clock-aligned trace, a
metrics rollup and a per-round fleet table (``observability/fleet.py``;
a fleet's ``replica<k>/obs/server`` sinks fold in as ranks);
``checkpoint-inspect`` lists a resume directory's checkpoints (round,
bytes, checksum status) and marks the newest verified one, the snapshot
``train(resume_from=...)`` and an elastic replay load; its exit status is
1 when nothing verifies. ``serve`` runs the model server's JSONL protocol
(``serving/server.py`` ``serve_main``: the JAX package's options, plus
``--device``, the card unless it says ``cpu``); ``serve-fleet`` runs N
``serve`` replicas behind one routing front (``serving/fleet``: the JAX
package's options, ``--device`` passed on to every replica);
``serve-report`` merges a server's or a fleet's serving observability into
latency, shed and coalescing tables and one trace
(``observability/serve_report.py``); ``deliver`` is the operator client of
a running server's ``deliver`` op.

``perf-report`` renders the banked perf ledger (``BENCH_r*.json`` under
``--root``, ``observability/ledger.py``); ``grow-report`` renders the
per-depth x per-op ``grow_detail`` of kernel-profiled rounds
(``XGBTPU_KERNEL_PROF``) from a run's flight sinks, either package's
(``observability/kernelprof.py``). The JAX package's ``lint`` and
``dispatch-report`` are not in the port: each prints so and returns 1.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Tuple

import numpy as np

from .data.dmatrix import DMatrix
from .learner import Booster
from .training import train
from .utils import console_logger

__all__ = ["parse_config_file", "cli_main", "checkpoint_inspect_main",
           "deliver_main", "main"]

#: the JAX package's subcommands that have no counterpart in the port
NOT_PORTED = ("lint", "dispatch-report")


def parse_config_file(path: str) -> List[Tuple[str, str]]:
    """key=value lines; '#' starts a comment (reference
    ``src/common/config.h``)."""
    out: List[Tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"bad config line: {line!r}")
            k, _, v = line.partition("=")
            out.append((k.strip(), v.strip().strip('"')))
    return out


_CLI_KEYS = {
    "task", "data", "test:data", "model_in", "model_out", "model_dir",
    "num_round", "save_period", "dump_format", "name_pred", "name_fmap",
    "name_dump", "fmap", "with_stats", "iteration_begin", "iteration_end",
    "silent",
}


def _split_params(pairs: List[Tuple[str, str]]):
    """``(cli keys, booster parameters, [(eval name, path)])``."""
    cli: Dict[str, str] = {}
    params: Dict[str, Any] = {}
    evals: List[Tuple[str, str]] = []
    for k, v in pairs:
        if k.startswith("eval[") and k.endswith("]"):
            evals.append((k[5:-1], v))
        elif k in _CLI_KEYS:
            cli[k] = v
        else:
            params[k] = v
    return cli, params, evals


def cli_main(argv: List[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 1
    if argv[0] == "trace-report":
        from .observability.report import main as report_main

        return report_main(argv[1:])
    if argv[0] == "obs-report":
        from .observability.fleet import main as fleet_main

        return fleet_main(argv[1:])
    if argv[0] == "checkpoint-inspect":
        return checkpoint_inspect_main(argv[1:])
    if argv[0] == "deliver":
        return deliver_main(argv[1:])
    if argv[0] == "serve":
        from .serving.server import serve_main

        return serve_main(argv[1:])
    if argv[0] == "serve-report":
        from .observability.serve_report import main as serve_report_main

        return serve_report_main(argv[1:])
    if argv[0] == "serve-fleet":
        from .serving.fleet.supervisor import serve_fleet_main

        return serve_fleet_main(argv[1:])
    if argv[0] == "perf-report":
        from .observability.ledger import main as ledger_main

        return ledger_main(argv[1:])
    if argv[0] == "grow-report":
        from .observability.kernelprof import main as kernelprof_main

        return kernelprof_main(argv[1:])
    if argv[0] in NOT_PORTED:
        print(f"{argv[0]}: not in the PyTorch port (the JAX package's "
              "xgboost_tpu has it)", file=sys.stderr)
        return 1
    pairs = parse_config_file(argv[0])
    for extra in argv[1:]:
        k, _, v = extra.partition("=")
        pairs.append((k, v))
    cli, params, eval_specs = _split_params(pairs)
    task = cli.get("task", "train")
    # the matrices' device: the card unless the config asks for the CPU
    device = params.get("device") or None

    if task == "train":
        dtrain = DMatrix(cli["data"], device=device)
        evals = [(DMatrix(p, device=device), name) for name, p in eval_specs]
        evals.append((dtrain, "train"))
        num_round = int(cli.get("num_round", 10))
        save_period = int(cli.get("save_period", 0))
        model_dir = cli.get("model_dir", "")
        callbacks = []
        if save_period > 0:
            from .callback import TrainingCheckPoint

            callbacks.append(TrainingCheckPoint(
                model_dir or ".", name="", interval=save_period))
        xgb_model = None
        if cli.get("model_in"):
            xgb_model = Booster(params, model_file=cli["model_in"],
                                device=dtrain.device)
        bst = train(params, dtrain, num_boost_round=num_round, evals=evals,
                    verbose_eval=not int(cli.get("silent", 0)),
                    xgb_model=xgb_model, callbacks=callbacks)
        out = cli.get("model_out", os.path.join(
            model_dir, f"{num_round:04d}.model") if model_dir
            else f"{num_round:04d}.model.json")
        bst.save_model(out)
        console_logger.info(f"model saved to {out}")
    elif task == "dump":
        bst = Booster(params, model_file=cli["model_in"], device=device)
        fmap = cli.get("name_fmap", cli.get("fmap", ""))
        out = cli.get("name_dump", "dump.txt")
        bst.dump_model(out, fmap=fmap,
                       with_stats=bool(int(cli.get("with_stats", 0))),
                       dump_format=cli.get("dump_format", "text"))
        console_logger.info(f"dump saved to {out}")
    elif task == "pred":
        bst = Booster(params, model_file=cli["model_in"], device=device)
        dtest = DMatrix(cli["test:data"], device=device)
        begin = int(cli.get("iteration_begin", 0))
        end = int(cli.get("iteration_end", 0))
        it_range = (begin, end) if (begin, end) != (0, 0) else None
        preds = bst.predict(dtest, iteration_range=it_range)
        out = cli.get("name_pred", "pred.txt")
        np.savetxt(out, np.asarray(preds), fmt="%.9g")
        console_logger.info(f"predictions saved to {out}")
    else:
        print(f"unknown task: {task}", file=sys.stderr)
        return 1
    return 0


def checkpoint_inspect_main(argv: List[str]) -> int:
    """``checkpoint-inspect <dir> [--json]``: what a resume directory
    holds, what verifies, and what a resume would load
    (``resilience.checkpoint.inspect_dir``). ``--json`` prints one
    document: the records and the newest verified path. Exit status 1 when
    nothing verifies."""
    import json

    from .resilience.checkpoint import inspect_dir

    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if not argv or argv[0].startswith("-"):
        print("usage: python -m xgboost_tpu_torch checkpoint-inspect <dir> "
              "[--json]", file=sys.stderr)
        return 1
    directory = argv[0]
    records = inspect_dir(directory)
    if as_json:
        newest = [r for r in records if r["newest_verified"]]
        # a directory with rank<r>/ subdirectories marks one newest
        # verified snapshot in each: the answer is the most advanced
        best = max(newest, key=lambda r: r["rounds"]) if newest else None
        print(json.dumps({
            "dir": directory,
            "records": records,
            "newest_verified": best["path"] if best else None,
            "newest_verified_rounds": best["rounds"] if best else None,
        }, indent=2))
        return 0 if best else 1
    if not records:
        print(f"{directory}: no checkpoints found")
        return 1
    print(f"{'':2} {'round':>8} {'bytes':>12} {'status':<40} path")
    any_ok = False
    for rec in records:
        mark = "*" if rec["newest_verified"] else " "
        status = ("verified" if rec["verified"]
                  else f"CORRUPT: {rec['detail']}")
        any_ok = any_ok or rec["verified"]
        print(f"{mark:2} {rec['rounds']:>8} {rec['bytes']:>12} "
              f"{status:<40} {rec['path']}")
    print("\n'*' = newest verified (what train(resume_from=...) / "
          "elastic replay loads)")
    return 0 if any_ok else 1


def deliver_main(argv: List[str]) -> int:
    """``deliver``: the operator client of the serving ``deliver`` op
    (the JAX package's ``deliver_main``): attach, inspect or stop a
    train-to-serve delivery controller on a running server over the JSONL
    protocol::

        python -m xgboost_tpu_torch deliver --connect HOST:PORT \\
            --model M --watch CKPT_DIR [--mode shadow|fraction]
            [--fraction F] [--min-requests N] [--bake-s S] [--poll-s S]
            [--dauc TOL] [--p99-ratio R] [--from-rounds N] [--eval-npz FILE]
        python -m xgboost_tpu_torch deliver --connect HOST:PORT --status
        python -m xgboost_tpu_torch deliver --connect HOST:PORT --stop --model M
    """
    import json
    import socket

    usage = ("usage: python -m xgboost_tpu_torch deliver --connect "
             "HOST:PORT (--model M --watch DIR [opts] | --status | --stop "
             "--model M)")
    msg: Dict[str, Any] = {"op": "deliver"}
    connect = None
    flags = {"--model": ("model", str), "--watch": ("watch", str),
             "--mode": ("mode", str), "--fraction": ("fraction", float),
             "--min-requests": ("min_requests", int),
             "--bake-s": ("bake_s", float), "--poll-s": ("poll_s", float),
             "--dauc": ("dauc_tol", float),
             "--p99-ratio": ("p99_ratio", float),
             "--from-rounds": ("from_rounds", int),
             "--eval-npz": ("eval_npz", str)}
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a == "--connect":
                i += 1
                connect = argv[i]
            elif a == "--status":
                msg["action"] = "status"
            elif a == "--stop":
                msg["action"] = "stop"
            elif a in flags:
                key, conv = flags[a]
                i += 1
                msg[key] = conv(argv[i])
            else:
                raise ValueError(f"unknown deliver option: {a!r}")
            i += 1
        if connect is None:
            raise ValueError("--connect HOST:PORT is required")
        if msg.get("action", "start") == "start" \
                and not (msg.get("model") and msg.get("watch")):
            raise ValueError("starting a delivery needs --model and "
                             "--watch")
        host, _, port = connect.rpartition(":")
        port = int(port)
    except (ValueError, IndexError) as e:
        print(f"deliver: {e}", file=sys.stderr)
        print(usage, file=sys.stderr)
        return 1
    try:
        with socket.create_connection((host or "127.0.0.1", port),
                                      timeout=30) as s:
            fh = s.makefile("rw", encoding="utf-8")
            fh.write(json.dumps(msg) + "\n")
            fh.flush()
            line = fh.readline()
    except OSError as e:
        print(f"deliver: cannot reach {connect}: {e}", file=sys.stderr)
        return 1
    try:
        resp = json.loads(line)
    except ValueError:
        print(f"deliver: bad response: {line!r}", file=sys.stderr)
        return 1
    print(json.dumps(resp, indent=2))
    return 0 if not resp.get("error") else 1


def main() -> None:
    """The console entry point."""
    sys.exit(cli_main(sys.argv[1:]))

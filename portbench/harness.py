"""One run of one cell: set-up, the measured window, the check, the line.

A cell is found by its name: its entry in ``BENCHMARK.json``, its traffic
in ``workloads/<cell>.json``, its configuration in
``configs/<config>.json``, and each part the configuration names in a
file of its own (``lookup``): each metric's reader in
``metrics/<metric>.py``, the data rule in ``rules/``, the objective's and
the evaluation metrics' references in ``reference/``. A run

1. draws the rows on the device from the seed (``traffic.make``) and
   hands them to the program as host numpy arrays;
2. builds ``QuantileDMatrix`` for the training rows and, with
   ``ref=dtrain``, for the held-out rows (``ingest_s``);
3. calls ``xgboost_tpu_torch.train`` with one evaluation set and the
   ``Window`` callback, which lets the warm rounds pass, opens the window
   at a round boundary that ends in a synchronize, and stops training at
   the first round boundary once ``seconds`` have passed;
4. reads the device's peak memory, collects what the program made, frees
   the program's state, and runs the comparison (``judge``);
5. reads each metric of the cell.

With ``trace`` the run also profiles rounds 4-6 with ``torch.profiler``
(``devtrace``) and samples rounds 8, 10 and 12 with the program's grow
profiler (``XGBTPU_KERNEL_PROF``, whose records the run keeps as
``grow_details`` and ``round_details``), keeps the host time of those six
rounds apart from the window's other rounds, and reports the per-layer
metrics.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

from . import lookup

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "xgboost_tpu")
#: rounds under torch.profiler, and rounds under the grow profiler
PROFILED_ROUNDS = (4, 5, 6)
GROW_PROFILED_ROUNDS = (8, 10, 12)
#: more rounds than any window runs; the window callback ends training
MAX_ROUNDS = 1_000_000


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """Everything the harness knows of cell ``name``, found by names."""
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "entry": entry,
        "traffic": _load(os.path.join(BENCH, "workloads", name + ".json")),
        "config": _load(os.path.join(BENCH, "configs", entry["config"] + ".json")),
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return lookup.find("metrics", metric).read


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose whole top-level name is a forbidden one."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def params_of(c: dict) -> dict:
    params = dict(c["config"]["params"])
    params.update(c["traffic"].get("params", {}))
    return params


@dataclasses.dataclass
class Run:
    """What a metric's reader may read."""

    shapes: dict  # n, F, B, depth, m_eval, objective, groups
    device_name: str
    setup_s: float
    ingest_s: float
    window_s: float
    window_rounds: int
    #: the traced run's window less the rounds a profiler watched: (s, rounds)
    plain: Optional[tuple] = None
    profile: Optional[dict] = None  # devtrace.reduce of the traced rounds
    grow_details: List[dict] = dataclasses.field(default_factory=list)
    round_details: List[dict] = dataclasses.field(default_factory=list)


def make_window(TrainingCallback, warm: int, seconds: float, sync, profile=None,
                min_rounds: int = 0):
    """The window callback (a subclass of the program's ``TrainingCallback``).
    ``profile`` is a pair of functions started before round
    ``PROFILED_ROUNDS[0]`` and stopped after its last; the window does not
    close before ``min_rounds`` rounds have run. With ``profile`` the
    window also sums the host time of its rounds that a profiler watched
    (``PROFILED_ROUNDS`` and ``GROW_PROFILED_ROUNDS``), so that the others'
    pace can be read apart."""
    watched = set(PROFILED_ROUNDS) | set(GROW_PROFILED_ROUNDS)

    class Window(TrainingCallback):
        def __init__(self):
            self.t_open = self.t_close = None
            self.rounds = 0
            self.history = {}
            self.profile_s = None
            self.watched_s = 0.0
            self.watched_rounds = 0
            self._last = None

        def before_iteration(self, model, epoch, evals_log):
            if profile is not None and epoch == PROFILED_ROUNDS[0]:
                sync()
                profile[0]()
                self._p0 = time.perf_counter()
            return False

        def after_iteration(self, model, epoch, evals_log):
            self.history = evals_log
            if profile is not None and epoch == PROFILED_ROUNDS[-1]:
                sync()
                self.profile_s = time.perf_counter() - self._p0
                profile[1]()
            if epoch == warm - 1:
                sync()
                self.t_open = self._last = time.perf_counter()
            elif self.t_open is not None:
                now = time.perf_counter()
                if profile is not None and epoch in watched:
                    self.watched_s += now - self._last
                    self.watched_rounds += 1
                self._last = now
                if now - self.t_open >= seconds and epoch + 1 >= min_rounds:
                    sync()
                    self.t_close = time.perf_counter()
                    self.rounds = epoch + 1 - warm
                    return True
            return False

    return Window()


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[dict] = None,
             t_start: Optional[float] = None, log=None,
             marks: Optional[Dict[str, float]] = None) -> dict:
    """One run of cell ``name``; the result line's object (without the
    forbidden-module check, which the caller makes once the run is over).
    ``overrides`` replace traffic keys (the tests' small sizes); ``marks``
    are the caller's clock readings once ``torch`` and once the program
    were imported, where it imported them itself."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t0 = time.perf_counter() if t_start is None else t_start
    c = cell(name)
    c["traffic"].update(overrides or {})
    traffic_spec, config = c["traffic"], c["config"]
    params = params_of(c)
    groups = lookup.objective(params["objective"]).outputs(params)
    warm = int(traffic_spec["warm_rounds"])
    if trace:
        os.environ["XGBTPU_KERNEL_PROF"] = "rounds=" + ",".join(
            map(str, GROW_PROFILED_ROUNDS))
    else:
        os.environ.pop("XGBTPU_KERNEL_PROF", None)

    import torch
    t_torch = (marks or {}).get("torch", time.perf_counter())

    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.callback import TrainingCallback

    from . import devtrace, judge, round_detail, traffic
    t_import = (marks or {}).get("program", time.perf_counter())

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.empty(1, device=dev)
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
    t_ctx = time.perf_counter()
    data = traffic.make(config, traffic_spec, seed, dev)
    sync()
    t_data = time.perf_counter()
    B = int(params["max_bin"])
    dtrain = xgbt.QuantileDMatrix(data.train.X, data.train.y, group=data.train.sizes,
                                  max_bin=B, device=str(dev))
    dvalid = xgbt.QuantileDMatrix(data.valid.X, data.valid.y, group=data.valid.sizes,
                                  max_bin=B, ref=dtrain, device=str(dev))
    sync()
    t_ingest = time.perf_counter()

    prof = None
    profile_fns = None
    trace_file = None
    if trace:
        trace_file = os.path.join(tempfile.gettempdir(),
                                  f"portbench-trace-{os.getpid()}.json")
        xgbt.set_config(trace_path=trace_file)
        # the card's activity and the runtime calls that launch it; host
        # operators stay unrecorded, which keeps the profiler's own cost
        # out of the rounds it times (the program's spans name the host's
        # work)
        acts = [torch.profiler.ProfilerActivity.CUDA if on_card
                else torch.profiler.ProfilerActivity.CPU]
        # the profiler's own start-up (CUPTI) paid here, not in round 4
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=dev).add_(1)
            sync()
        prof = torch.profiler.profile(activities=acts)
        profile_fns = (prof.__enter__, lambda: prof.__exit__(None, None, None))
    window = make_window(TrainingCallback, warm, seconds, sync, profile_fns,
                         min_rounds=max(GROW_PROFILED_ROUNDS) + 1 if trace else 0)
    try:
        bst = xgbt.train(params, dtrain, num_boost_round=MAX_ROUNDS,
                         evals=[(dvalid, "valid")], verbose_eval=False,
                         callbacks=[window])
    finally:
        if trace and window.profile_s is None and getattr(prof, "profiler", None):
            prof.__exit__(None, None, None)
    if window.t_close is None:
        raise RuntimeError("training ended before the window closed")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    setup_s = window.t_open - t0
    parts = {"import_torch": t_torch - t0, "import_program": t_import - t_torch,
             "context": t_ctx - t_import,
             "data": t_data - t_ctx, "ingest": t_ingest - t_data,
             "warm_rounds": window.t_open - t_ingest}
    log("setup_s " + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
        + f" total={setup_s:.3f}")

    rounds = warm + window.rounds
    run = Run(shapes={"n": int(data.train.X.shape[0]), "F": int(data.train.X.shape[1]),
                      "B": B, "depth": int(params["max_depth"]),
                      "m_eval": int(data.valid.X.shape[0]),
                      "objective": params["objective"], "groups": groups},
              device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
              setup_s=setup_s, ingest_s=t_ingest - t_data,
              window_s=window.t_close - window.t_open, window_rounds=window.rounds)
    if trace:
        from xgboost_tpu_torch.observability import flight
        from xgboost_tpu_torch.observability import trace as ptrace

        run.plain = (run.window_s - window.watched_s,
                     window.rounds - window.watched_rounds)
        run.grow_details = [r["grow_detail"] for r in flight.RECORDER.records()
                            if "grow_detail" in r]
        run.round_details = round_detail.records()
        spans = []
        if window.profile_s is not None:
            ptrace.flush(trace_file)
            spans = ptrace.load_trace(trace_file)
            run.profile = devtrace.reduce(
                prof, window.profile_s, len(PROFILED_ROUNDS), spans,
                ptrace.clock_base()["unix_ns"])
        xgbt.set_config(trace_path=None)
        if os.path.exists(trace_file):
            os.remove(trace_file)

    out = judge.collect(bst, dtrain, dvalid, window.history,
                        int(params["max_depth"]), rounds, groups)
    del bst, dtrain, dvalid, window, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = judge.compare(out, data, params, warm, seed, dev)
    log(f"check_s {time.perf_counter() - t_check:.3f}")
    limits = {k: float(v) for k, v in traffic_spec["limits"].items()}
    correct, failed = judge.verdict(checks, limits)

    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu", "kind": run.device_name,
              "count": 1 if on_card else 0, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": rounds, "failed": len(failed),
              "metrics": metrics, "device": device}
    if trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        result["breakdown"] = run.profile["breakdown"]
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in judge.CHECKS}
    log(f"rounds {rounds} (warm {warm}, window {run.window_rounds} rounds in "
        f"{run.window_s:.3f} s)")
    for k in judge.CHECKS:
        log(f"check {k} {checks[k]!r} limit {limits[k]!r}"
            + ("" if k not in failed else "  FAILED"))
    return result

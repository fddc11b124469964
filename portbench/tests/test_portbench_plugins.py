"""A configuration the harness has no file for comes in as new files alone.

The test copies ``portbench/`` to a temporary directory and adds, as new
files only, what a three-class ``multi:softprob`` configuration names: its
objective's reference (``G`` = ``num_class`` outputs), the ``mlogloss``
metric's reference, the configuration (``make_classification`` with
``n_classes`` 3) and a workload, with their entries in a copy of
``BENCHMARK.json`` beside the copied folder. A run of the copy's harness
on the CPU at a small size is correct with rounds of three trees; two
planted faults, a model whose round's trees come in another class order
(its trees alone, and its trees with their groups in the dump), and the
control at G = 3 are not; no file of the copy but the added ones changed.

Run: ``python -m pytest portbench/tests -q``.
"""

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MULTI_SOFTPROB = '''"""``multi:softprob``: ``num_class`` outputs; per row ``p = softmax(margin)``,
``g = p - onehot(y)``, ``h = max(2 p (1 - p), 1e-16)``, in float64. Rows
start from ``base_score`` (0.5 unless the configuration sets it)."""

import torch

from portbench.work import Work

F64 = torch.float64


def outputs(params):
    return int(params["num_class"])


def base_margin(params):
    return float(params.get("base_score", 0.5))


def gradient(margin, y, sizes, iteration):
    p = torch.softmax(margin.to(F64), dim=1)
    onehot = torch.nn.functional.one_hot(y.long(), margin.shape[1]).to(F64)
    return p - onehot, torch.clamp(2.0 * p * (1.0 - p), min=1e-16)


def work(n, groups):
    """Reads G margins and a label, writes G (g, h) pairs; about 10
    operations an output (the exponential, the sum, the quotient)."""
    return Work(n * (4 * groups + 4 + 8 * groups), 10 * n * groups)
'''

MLOGLOSS = '''"""``mlogloss``: the mean of ``-log(p_y)`` in float64, ``p`` the row's
softmax of its margins rounded to their type, clipped below at 1e-16."""

import torch

F64 = torch.float64


def evaluate(margin, y, sizes, arg):
    p = torch.softmax(margin.to(F64), dim=1).to(margin.dtype).to(F64)
    picked = torch.gather(p, 1, y.long()[:, None])[:, 0]
    return float((-torch.log(torch.clamp(picked, min=1e-16))).mean())
'''

CONFIG = {
    "name": "seam-mc3",
    "source": "https://scikit-learn.org/stable/modules/generated/sklearn.datasets.make_classification.html",
    "params": {"objective": "multi:softprob", "num_class": 3, "tree_method": "hist",
               "max_depth": 4, "eta": 0.3, "max_bin": 64, "eval_metric": ["mlogloss"]},
    "data": {"features": 8, "label": "make_classification", "informative": 8,
             "n_classes": 3, "clusters_per_class": 2, "class_sep": 1.0,
             "flip_y": 0.01, "missing": 0.0},
}
WORKLOAD = {
    "name": "seam-mc3.small", "config": "seam-mc3", "rows": 3000, "eval_rows": 1000,
    "warm_rounds": 3,
    "limits": {"cut_mismatch": 0, "bin_mismatch": 0, "tree_count_gap": 0,
               "gain_gap": 1e-05, "leaf_gap": 1e-05, "train_margin_gap": 1e-05,
               "valid_margin_gap": 1e-05, "metric_gap": 2e-06},
}


def _files(top: str) -> Dict[str, bytes]:
    out = {}
    for d, dirs, names in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, top)] = f.read()
    return out


def plant(dest: str, config: dict, workload: dict, objective_file: str,
          metric_files: Dict[str, str]) -> List[str]:
    """Copies ``portbench/`` into ``dest`` and adds the configuration's
    files, as a later change would; writes ``dest/BENCHMARK.json`` with the
    configuration's and the workload's entries. Returns the added paths
    (relative to ``dest/portbench``)."""
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    added = {
        f"reference/objectives/{config['params']['objective'].replace(':', '_')}.py":
            objective_file,
        f"configs/{config['name']}.json": json.dumps(config, indent=2),
        f"workloads/{workload['name']}.json": json.dumps(workload, indent=2),
    }
    added.update({f"reference/metrics/{k}.py": v for k, v in metric_files.items()})
    for rel, text in added.items():
        path = os.path.join(dest, "portbench", rel)
        assert not os.path.exists(path), rel
        with open(path, "w") as f:
            f.write(text)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": config["name"], "source": config["source"],
                            "file": f"portbench/configs/{config['name']}.json",
                            "reduced": [], "why": "a seam test"})
    spec["workloads"].append({"name": workload["name"], "config": config["name"],
                              "traffic": workload["name"].split(".", 1)[1], "chips": 1,
                              "why": "a seam test"})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=2)
    return sorted(added)


#: runs in the copy: a sound run, faults, the control; prints one JSON line
SCRIPT = r'''
import json, sys
sys.path[:0] = [%(dest)r, %(root)r]
from portbench import control, faults, harness, judge, traffic
assert harness.__file__.startswith(%(dest)r), harness.__file__
CELL, SEED, G = %(cell)r, %(seed)d, %(groups)d
shapes = []
collect = judge.collect


def seen(*a, **k):
    out = collect(*a, **k)
    shapes.append([list(out.train_margin.shape), list(out.valid_margin.shape)])
    return out


def reordered(with_groups):
    def f(*a, **k):
        out = collect(*a, **k)
        for i in range(0, len(out.trees) - G + 1, G):
            out.trees[i:i + G] = out.trees[i + 1:i + G] + out.trees[i:i + 1]
            if with_groups:
                out.tree_groups[i:i + G] = out.tree_groups[i + 1:i + G] + out.tree_groups[i:i + 1]
        return out
    return f


def run(name, patch=None):
    judge.collect = patch or seen
    try:
        r = harness.run_cell(CELL, SEED, 0.3, False, "cpu", log=lambda m: None)
    finally:
        judge.collect = collect
    res[name] = [r["correct"], {k: v["value"] for k, v in r["checks"].items()}]


res = {}
run("sound")
with faults.altered_leaf():
    run("altered_leaf")
with faults.half_batch():
    run("half_batch")
run("class_order", reordered(False))
run("class_order_in_the_dump", reordered(True))
c = harness.cell(CELL)
params = harness.params_of(c)
data = traffic.make(c["config"], c["traffic"], SEED + 1, "cpu")
out = control.outputs(data, params, 3, "cpu")
checks = judge.compare(out, data, params, 3, SEED + 1, "cpu")
res["control"] = [judge.verdict(checks, c["traffic"]["limits"])[0], checks]
res["shapes"] = shapes[0]
print(json.dumps(res))
'''


def test_a_multiclass_configuration_comes_in_as_new_files(tmp_path):
    dest = str(tmp_path)
    before = _files(os.path.join(ROOT, "portbench"))
    added = plant(dest, CONFIG, WORKLOAD, MULTI_SOFTPROB, {"mlogloss": MLOGLOSS})
    code = SCRIPT % {"dest": dest, "root": ROOT, "cell": WORKLOAD["name"],
                     "seed": 2**31 + 91, "groups": 3}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=dest)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    ok, checks = res["sound"]
    assert ok and checks["tree_count_gap"] == 0, checks
    assert res["shapes"] == [[3000, 3], [1000, 3]]
    for bad in ("altered_leaf", "half_batch", "class_order", "class_order_in_the_dump",
                "control"):
        assert res[bad][0] is False, (bad, res[bad][1])
    after = _files(os.path.join(dest, "portbench"))
    assert sorted(set(after) - set(before)) == added
    assert all(after[k] == v for k, v in before.items())

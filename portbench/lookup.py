"""How the harness finds what a configuration names: a file of its own.

Every part that a cell names is a Python file under this folder, found by
the name and loaded from its path:

- a metric's reader: ``metrics/<metric>.py`` (``read(run)``);
- a configuration's data rule, ``config["data"]["label"]``:
  ``rules/<label>.py`` (``make(config, workload, seed, device)``);
- an objective's reference, ``params["objective"]`` with ``:`` as ``_``:
  ``reference/objectives/<name>.py`` (``outputs``, ``base_margin``,
  ``gradient``, ``work``);
- an evaluation metric's reference, ``<name>@<arg>``:
  ``reference/metrics/<name>.py`` (``evaluate(margin, y, sizes, arg)``).

A later configuration brings its own files beside these; no file lists
the names. A name without a file raises, naming the path looked for.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))


def find(folder: str, name: str):
    """The module of ``<folder>/<name>.py`` under this folder."""
    path = os.path.join(BENCH, folder, name + ".py")
    if "/" in name or not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder} file for {name!r}: looked for {path}")
    key = "portbench_found_" + re.sub(r"\W", "_", f"{folder}/{name}")
    mod = sys.modules.get(key)
    if mod is None or getattr(mod, "__file__", None) != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod


def rule(config: dict):
    """The data rule that draws ``config``'s rows."""
    return find("rules", config["data"]["label"])


def objective(name: str):
    """The reference of objective ``name`` (``binary:logistic``, ...)."""
    return find("reference/objectives", name.replace(":", "_"))


def metric(name: str):
    """``(module, arg)`` of evaluation metric ``name`` (``ndcg@10``: the
    module of ``ndcg`` and ``"10"``; no ``@``: ``None``)."""
    base, at, arg = name.partition("@")
    return find("reference/metrics", base), (arg if at else None)

"""The port stands alone and has no hidden CPU fallback.

- importing ``xgboost_tpu_torch`` loads neither ``jax`` nor ``xgboost_tpu``;
- no module of the package, nor ``chip_smoke.py`` or the port's profile
  script, imports either (AST);
- without a CUDA device, entry points that were not asked for the CPU
  raise;
- a tensor that is not on the CPU goes to the kernel wrapper (checked with
  a stub kernel library that records its calls), never to the plain
  version: kernel A with uint8 and int16 bins, kernel D when a one-hot is
  given, kernel C for the one-hot itself, kernel S for every strict-order
  scan of split evaluation (two a level); a device with no kernel, a failed
  build, or a failed one-hot build raises, with no degrade to another route;
- categorical decision tables ``[Kp, 5+B]`` reach kernels A and D with
  their width, and a table of any other width raises;
- kernel B takes an input of more than 2^31 elements in row chunks, each
  launch below 2^31 elements; a forest with categorical nodes takes the
  categorical walk and never reaches kernel B, whose wrapper refuses it;
- the training surface (``callback.py``, ``training.py``) and the random
  stream (``threefry.py``) import neither ``jax`` nor ``xgboost_tpu``, and
  a pickled or copied Booster made for the card comes back on the card,
  raising where there is none;
- row and column samples of data on a device are drawn there: the draws,
  the sampled gradients and the feature masks never come back to the CPU
  (only the keys, two integers each, live on the host);
- the multiclass and survival objectives and metrics import neither
  ``jax`` nor ``xgboost_tpu``; a 3-class Booster made for the card sends
  its eval walk and its training walk to kernel B's wrapper with G = 3,
  and its softmax, gradients and (for ``survival:aft``) label bounds stay
  on the data's device; so do the ranking objectives' gradients;
- SHAP (``interpret.py``), the linear booster, the estimators, ``config``,
  the plots and the local histmaker (``tree/grow_local.py``) import
  neither ``jax`` nor ``xgboost_tpu``; a local histmaker tree on device
  tensors sends every level's histogram to kernel A's wrapper at
  ``d = 0``; the SHAP
  values (exact, Saabas, interactions; numerical and categorical trees,
  table and row-DP paths) of rows on a device and the linear booster's
  weights for every selector are computed there, with no host sync (the
  stub 'meta' device has no data to read back); an estimator built without
  ``device=`` raises where there is no card;
- the sparse, adapter, sketch, streaming and external-memory modules
  import neither ``jax`` nor ``xgboost_tpu``, and ``import
  xgboost_tpu_torch`` loads neither ``pandas`` nor ``pyarrow``; a paged
  tree on device tensors sends every page's level to kernel A's wrapper,
  and CSR ``inplace_predict`` on a device sends each row block to kernel
  B's;
- ``collective.py`` and ``parallel/*`` import neither ``jax`` nor
  ``xgboost_tpu``; ``init_distributed`` without ``device="cpu"`` raises
  where there is no card, before any rendezvous; under a row group a
  tree's level histograms reach kernel A's or D's wrapper and the tensors
  handed to ``torch.distributed.all_reduce`` are on that device (the int64
  histograms among them), never CPU copies;
- the resilience layer (``resilience/*``) imports neither ``jax`` nor
  ``xgboost_tpu``, nor does a run with ``resume_from`` under chaos, and a
  ``pallas`` chaos hit on a device tensor raises before kernel B's wrapper
  launches anything or reaches the plain walk;
- elastic training (``parallel/membership.py``, ``elastic_train``) and the
  command line (``cli.py``, ``__main__.py``, ``observability/fleet.py`` and
  ``report.py``) import neither ``jax`` nor ``xgboost_tpu``, the heartbeat
  agent's source imports only the standard library, and ``elastic_train``
  with a ``data_fn`` that does not ask for the CPU, the command line's
  ``train`` task without ``device=cpu`` and ``init_distributed(elastic=
  True)`` raise where there is no card;
- the serving layer (``predictor/serving.py``, ``serving/*``) imports
  neither ``jax`` nor ``xgboost_tpu`` (nor the JAX package's degrade
  machine's counterpart); a ``ModelServer`` or ``ModelRegistry`` built
  without ``device=`` raises where there is no card; a served dispatch on
  a device reaches kernel B's wrapper once, never the plain version, and
  a failure after the launch comes back as a typed ``RequestError``;
- the serving fleet (``serving/fleet/*``) and ``serve-report`` import
  neither ``jax`` nor ``xgboost_tpu``; the fleet's supervising process
  (supervisor and router) spawns, routes and stops replicas without one
  call into ``torch.cuda``; ``serve-fleet`` without ``--device`` where
  there is no card fails at once, its replica's log naming the card;
- the pipelined round loop (``pipeline.py``, ``utils/observer.py`` and the
  async checkpoint writer) imports neither ``jax`` nor ``xgboost_tpu``,
  nor does a pipelined run with checkpoints, the async writer and the
  observer on;
- the native host runtime (``native/*.py``) imports neither ``jax`` nor
  ``xgboost_tpu`` (AST), nor does a paged run and a parse through it; the
  modules the C API (``native/c_api.cpp``) imports are ``numpy``, ``json``
  or ``xgboost_tpu_torch``'s own; with the compiler pointed at ``false``
  the libsvm and csv loaders, ``PagedBins`` and the C API builder raise,
  and nothing falls back to the Python parsers or ``np.fromfile``.
"""

import ast
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch import _build
from xgboost_tpu_torch import predictor as tpred
from xgboost_tpu_torch.tree import grow as tgrow
from xgboost_tpu_torch.tree import hist_kernel as thk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "xgboost_tpu")


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import xgboost_tpu_torch\n"
        "new = [m for m in set(sys.modules) - before\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not new, new\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_import_of_jax_in_sources():
    files = sorted((ROOT / "xgboost_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              *sorted((ROOT / "scripts").glob("torch_*.py"))]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}: imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        xgbt.DMatrix(X)
    with pytest.raises(RuntimeError, match="cuda"):
        xgbt.Booster()
    with pytest.raises(RuntimeError, match="cuda"):
        xgbt.Booster({"objective": "binary:logistic"})
    # asking for the CPU works
    d = xgbt.DMatrix(X, np.zeros(4), device="cpu")
    assert d.data.device.type == "cpu"
    assert xgbt.Booster(device="cpu").device.type == "cpu"


def test_elastic_and_cli_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """``elastic_train`` with a ``data_fn`` that does not ask for the CPU,
    and the command line's ``train`` task without a ``device=cpu`` line,
    raise where there is no card."""
    from xgboost_tpu_torch import cli
    from xgboost_tpu_torch.observability import RECORDER

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((4, 2), np.float32)
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            xgbt.elastic_train({}, lambda r, w: xgbt.DMatrix(X, np.zeros(4)),
                               2, run_dir=str(tmp_path / "run"), world=1,
                               rank=0)
    finally:
        RECORDER.reset()
    data = tmp_path / "d.libsvm"
    data.write_text("1 0:1.5\n0 1:2\n")
    conf = tmp_path / "train.conf"
    conf.write_text(f"task=train\ndata={data}\nnum_round=1\n"
                    f"model_out={tmp_path}/m.json\n")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.cli_main([str(conf)])
    assert not (tmp_path / "m.json").exists()


class _StubLib:
    """Records kernel entry-point calls; returns CUDA success, or the code
    in ``status`` for the entry points named there."""

    def __init__(self):
        self.calls = []
        self.status = {}

    def __getattr__(self, name):
        if not name.startswith("xgbt_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return self.status.get(name, 0)
        return fn


@pytest.fixture
def stub_cuda(monkeypatch):
    """Tensors on the 'meta' device stand in for CUDA tensors (this torch
    build has none): they carry shapes and dtypes but no data."""
    lib = _StubLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "KERNEL_DEVICES", ("cuda", "meta"))
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda device: 0)

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for a device tensor")

    for name in ("_fused_level_plain", "_hoisted_level_plain",
                 "_build_onehot_plain"):
        monkeypatch.setattr(thk, name, no_plain)
    monkeypatch.setattr(tpred, "_predict_margin_plain", no_plain)
    monkeypatch.setattr(tgrow, "_seq_cumsum_plain", no_plain)
    return lib


#: kernel S's entry point, which every strict-order scan reaches
SCAN = "xgbt_seq_scan"


def _split_calls(calls):
    """``(the stub's calls but kernel S's, the number of kernel S's)``."""
    return [c for c in calls if c[0] != SCAN], sum(c[0] == SCAN for c in calls)


def _meta_level(n, F, Kp):
    meta = dict(device="meta")
    pos = torch.empty((n, 1), dtype=torch.int32, **meta)
    gq = thk.QuantizedGradients(q=torch.empty((n, 2), dtype=torch.int32, **meta),
                                exp=torch.empty(2, dtype=torch.int32, **meta))
    return pos, gq, torch.empty((max(Kp, 1), 4), dtype=torch.float32, **meta)


def test_device_tensor_reaches_the_level_kernel(stub_cuda):
    n, F, B, K, d = 300, 5, 16, 4, 2
    bins = torch.empty((n, F), dtype=torch.uint8, device="meta")
    pos, gq, ptab = _meta_level(n, F, 2)
    before = thk.fused_level.launches
    new_pos, hist = thk.fused_level(bins, pos, gq, ptab, K=K, Kp=2, B=B, d=d)
    assert thk.fused_level.launches == before + 1
    (name, args), = stub_cuda.calls
    assert name == "xgbt_fused_level"
    # (bins, bin_bytes, n, F, B, pos, pos_out, q, ptab, W, Kp, prev_offset,
    #  K, offset, ...)
    assert args[1:5] == (1, n, F, B) and args[9:14] == (4, 2, 1, K, 3)
    assert tuple(new_pos.shape) == (n, 1) and tuple(hist.shape) == (F, 2 * K, B)
    # int16 bins (max_bin 256) reach the kernel with their width; wider
    # storage raises, never falls back
    thk.fused_level(bins.to(torch.int16), pos, gq, ptab, K=K, Kp=2, B=256,
                    d=d)
    name, args = stub_cuda.calls[-1]
    assert name == "xgbt_fused_level" and args[1:5] == (2, n, F, 256)
    with pytest.raises(NotImplementedError):
        thk.fused_level(bins.to(torch.int32), pos, gq, ptab, K=K, Kp=2, B=B,
                        d=d)


def test_device_tensor_with_onehot_reaches_the_hoisted_kernel(stub_cuda):
    n, F, B, Fh, K, d = 300, 5, 256, 3, 4, 2
    bins = torch.empty((n, F), dtype=torch.int16, device="meta")
    pos, gq, ptab = _meta_level(n, F, 2)
    c0, d0, a0 = (thk.build_onehot.launches, thk.hoisted_level.launches,
                  thk.fused_level.launches)
    onehot = thk.build_onehot(bins, B=B, Fh=Fh)
    assert tuple(onehot.shape) == (Fh * B, 320) and onehot.dtype == torch.int8
    new_pos, hist = thk.fused_level(bins, pos, gq, ptab, K=K, Kp=2, B=B, d=d,
                                    onehot=onehot)
    assert (thk.build_onehot.launches, thk.hoisted_level.launches,
            thk.fused_level.launches) == (c0 + 1, d0 + 1, a0)
    (n1, a1), (n2, a2) = stub_cuda.calls
    # (bins, bin_bytes, n, F, Fh, B, n_pad, out, stream)
    assert n1 == "xgbt_build_onehot" and a1[1:7] == (2, n, F, Fh, B, 320)
    # (bins, bin_bytes, n, F, B, onehot, Fh, n_pad, pos, pos_out, q, ptab,
    #  W, Kp, prev_offset, K, offset, hist, records, unhoisted bins, stream)
    assert n2 == "xgbt_hoisted_level" and len(a2) == 21
    assert a2[1:5] == (2, n, F, B) and a2[6:8] == (Fh, 320)
    assert a2[12:17] == (4, 2, 1, K, 3)
    assert tuple(new_pos.shape) == (n, 1) and tuple(hist.shape) == (F, 2 * K, B)
    # a one-hot of the wrong shape raises
    with pytest.raises(ValueError, match="one-hot"):
        thk.fused_level(bins, pos, gq, ptab, K=K, Kp=2, B=B, d=d,
                        onehot=onehot[:, :n])


def test_failed_onehot_build_raises(stub_cuda, monkeypatch):
    """A matrix whose plan hoists builds its one-hot when training first
    asks for it (``fused_onehot``); a failed build raises there, with no
    degrade to the construct route."""
    from xgboost_tpu_torch.data.quantile import BinnedMatrix, HistogramCuts

    monkeypatch.setenv("XGBTPU_HOIST_BUDGET_MB", "1024")
    stub_cuda.status["xgbt_build_onehot"] = 2  # cudaErrorMemoryAllocation
    n, F, B = 1000, 6, 64
    binned = BinnedMatrix(
        cuts=HistogramCuts(np.zeros((F, B), np.float32), np.zeros(F, np.float32)),
        bins=torch.empty((n, F), dtype=torch.uint8, device="meta"),
        cut_values=torch.empty((F, B), device="meta"))
    with pytest.raises(RuntimeError, match="build_onehot: CUDA error 2"):
        binned.fused_onehot()
    names = [c[0] for c in stub_cuda.calls]
    assert names == ["xgbt_build_onehot"]


def test_device_tensor_reaches_the_walk_kernel(stub_cuda):
    n, F, T, N = 50, 4, 3, 7
    meta = dict(device="meta")
    forest = tpred.StackedForest(
        left=torch.empty((T, N), dtype=torch.int32, **meta),
        right=torch.empty((T, N), dtype=torch.int32, **meta),
        feature=torch.empty((T, N), dtype=torch.int32, **meta),
        cond=torch.empty((T, N), dtype=torch.float32, **meta),
        default_left=torch.empty((T, N), dtype=torch.bool, **meta),
        tree_group=torch.empty(T, dtype=torch.int32, **meta),
        max_depth=2, n_groups=1, num_feature=F)
    X = torch.empty((n, F), dtype=torch.float32, **meta)
    before = tpred.predict_margin.launches
    out = tpred.predict_margin(forest, X, torch.empty((n, 1), **meta))
    assert tpred.predict_margin.launches == before + 1
    (name, args), = stub_cuda.calls
    assert name == "xgbt_predict_margin"
    # (X, n, F, node records, tree_group, tree_weight, T, N, max_depth, G,
    #  base, out, stream)
    assert args[1:3] == (n, F) and args[6:10] == (T, N, 2, 1)
    assert tuple(out.shape) == (n, 1)


def test_device_without_kernel_raises(monkeypatch):
    monkeypatch.setattr(thk, "_fused_level_plain", None)
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        thk.fused_level(torch.empty((8, 2), dtype=torch.uint8, **meta),
                        torch.empty((8, 1), dtype=torch.int32, **meta),
                        thk.QuantizedGradients(
                            torch.empty((8, 2), dtype=torch.int32, **meta),
                            torch.empty(2, dtype=torch.int32, **meta)),
                        torch.empty((1, 4), **meta), K=1, Kp=0, B=4, d=0)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="build failed"):
        _build.library("hist_level")


@pytest.mark.parametrize("route", ["construct", "hoisted"])
def test_categorical_table_reaches_the_level_kernels_with_its_width(
        stub_cuda, route):
    n, F, B, K, d = 300, 5, 256, 4, 2
    bins = torch.empty((n, F), dtype=torch.int16, device="meta")
    pos, gq, _ = _meta_level(n, F, 2)
    onehot = (thk.build_onehot(bins, B=B, Fh=3) if route == "hoisted"
              else None)
    ptab = torch.empty((2, 5 + B), dtype=torch.float32, device="meta")
    thk.fused_level(bins, pos, gq, ptab, K=K, Kp=2, B=B, d=d, onehot=onehot)
    name, args = stub_cuda.calls[-1]
    if route == "hoisted":
        assert name == "xgbt_hoisted_level" and args[12:14] == (5 + B, 2)
    else:
        assert name == "xgbt_fused_level" and args[9:11] == (5 + B, 2)
    calls = len(stub_cuda.calls)
    for width in (5, 4 + B, 6 + B):
        bad = torch.empty((2, width), dtype=torch.float32, device="meta")
        with pytest.raises(ValueError, match="ptab"):
            thk.fused_level(bins, pos, gq, bad, K=K, Kp=2, B=B, d=d,
                            onehot=onehot)
    assert len(stub_cuda.calls) == calls


def _meta_forest(T, N, F, **cats):
    meta = dict(device="meta")
    return tpred.StackedForest(
        left=torch.empty((T, N), dtype=torch.int32, **meta),
        right=torch.empty((T, N), dtype=torch.int32, **meta),
        feature=torch.empty((T, N), dtype=torch.int32, **meta),
        cond=torch.empty((T, N), dtype=torch.float32, **meta),
        default_left=torch.empty((T, N), dtype=torch.bool, **meta),
        tree_group=torch.empty(T, dtype=torch.int32, **meta),
        max_depth=2, n_groups=1, num_feature=F, **cats)


def test_input_past_2_31_elements_reaches_the_walk_kernel_in_row_chunks(
        stub_cuda):
    F, T, N = 50, 3, 7
    n = (1 << 31) // F + 1  # n * F just past 2^31
    X = torch.empty((n, F), dtype=torch.float32, device="meta")
    before = tpred.predict_margin.launches
    out = tpred.predict_margin(_meta_forest(T, N, F), X,
                               torch.empty((n, 1), device="meta"))
    assert tuple(out.shape) == (n, 1)
    rows = [args[1] for name, args in stub_cuda.calls]
    assert [c[0] for c in stub_cuda.calls] == ["xgbt_predict_margin"] * 2
    assert tpred.predict_margin.launches == before + 2
    assert sum(rows) == n and all(r * F < 1 << 31 for r in rows)
    assert rows[0] % 256 == 0


def test_categorical_forest_takes_the_categorical_walk(stub_cuda,
                                                       monkeypatch):
    F, T, N, n = 4, 3, 7, 50
    forest = _meta_forest(
        T, N, F, has_cats=True,
        split_type=torch.empty((T, N), dtype=torch.bool, device="meta"),
        cat_bits=torch.empty((T, N, 1), dtype=torch.int32, device="meta"))
    X = torch.empty((n, F), dtype=torch.float32, device="meta")
    base = torch.empty((n, 1), device="meta")
    walked = []
    monkeypatch.setattr(tpred, "_predict_margin_cat",
                        lambda f, x, b, w: walked.append(f) or b)
    tpred.predict_margin(forest, X, base)
    assert walked == [forest] and stub_cuda.calls == []
    with pytest.raises(NotImplementedError, match="categorical"):
        tpred._predict_margin_cuda(forest, X, base,
                                   torch.empty(T, device="meta"))


@pytest.mark.parametrize("module", ["xgboost_tpu_torch.callback",
                                    "xgboost_tpu_torch.training",
                                    "xgboost_tpu_torch.threefry",
                                    "xgboost_tpu_torch.objective.multiclass",
                                    "xgboost_tpu_torch.objective.survival",
                                    "xgboost_tpu_torch.metric.multiclass",
                                    "xgboost_tpu_torch.metric.survival",
                                    "xgboost_tpu_torch.interpret",
                                    "xgboost_tpu_torch.gbm.gblinear",
                                    "xgboost_tpu_torch.sklearn",
                                    "xgboost_tpu_torch.config",
                                    "xgboost_tpu_torch.plotting",
                                    "xgboost_tpu_torch.tree.grow_local",
                                    "xgboost_tpu_torch.data.sparse",
                                    "xgboost_tpu_torch.data.adapters",
                                    "xgboost_tpu_torch.data.sketch",
                                    "xgboost_tpu_torch.data.iterator",
                                    "xgboost_tpu_torch.data.external"])
def test_training_surface_imports_no_jax(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path in set((ROOT / "xgboost_tpu_torch").rglob("*.py"))
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_card_booster_unpickles_only_onto_the_card(monkeypatch):
    import pickle

    X = np.random.RandomState(0).randn(64, 3).astype(np.float32)
    bst = xgbt.train({"max_depth": 2}, xgbt.DMatrix(X, X[:, 0] > 0,
                                                    device="cpu"), 1,
                     verbose_eval=False)
    assert pickle.loads(pickle.dumps(bst)).device.type == "cpu"
    bst.device = torch.device("cuda")  # as if made for the card
    raw = pickle.dumps(bst)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pickle.loads(raw)
    with pytest.raises(RuntimeError, match="cuda"):
        bst.copy()
    with pytest.raises(RuntimeError, match="cuda"):
        bst[:1]


def test_samples_are_drawn_on_the_data_device():
    from xgboost_tpu_torch import threefry
    from xgboost_tpu_torch.tree import grow as tgrow

    meta = dict(device="meta")
    key = threefry.prng_key(7)
    assert key.device.type == "cpu"
    g = torch.empty(1000, **meta)
    h = torch.empty(1000, **meta)
    for method in ("uniform", "gradient_based"):
        cfg = tgrow.GrowParams(subsample=0.5, sampling_method=method)
        out = tgrow.apply_row_sampling(cfg, key, g, h)
        assert all(t.device.type == "meta" for t in out), method
    w = torch.empty(50, **meta)
    for weights in (None, w):
        mask = tgrow._sample_features_exact(key, 50, 0.3, weights,
                                            device="meta")
        assert mask.device.type == "meta" and mask.dtype == torch.bool
    parent = torch.empty((8, 50), dtype=torch.bool, **meta)
    assert tgrow.exact_k_subset(key, parent, 5).device.type == "meta"


def _on_meta(bst, d):
    """``bst`` and ``d`` as if made for the card: every tensor on the stub
    tests' 'meta' device (shapes and dtypes, no data)."""
    meta = torch.device("meta")
    bst.device = bst._gbm.device = bst._gbm.model.device = meta
    out = xgbt.DMatrix.__new__(xgbt.DMatrix)
    out.__dict__.update(d.__dict__)
    out.device, out._binned = meta, {}
    for name in ("data", "label", "weight", "base_margin", "feature_weights",
                 "label_lower_bound", "label_upper_bound"):
        v = getattr(d, name)
        setattr(out, name, None if v is None else v.to(meta))
    return out


_MC = {"objective": "multi:softprob", "num_class": 3, "max_depth": 2,
       "eval_metric": "mlogloss"}
_AFT = {"objective": "survival:aft", "max_depth": 2}


def _aft_labels():
    rng = np.random.RandomState(2)
    t = rng.gamma(2.0, 10.0, 300).astype(np.float32)
    upper = np.where(rng.rand(300) < 0.3, np.inf, t).astype(np.float32)
    return t, dict(label_lower_bound=t, label_upper_bound=upper)


@pytest.fixture(scope="module")
def cpu_models():
    """Two-round models trained on the CPU (before the stub card replaces
    the plain versions): 3-class and AFT, as model bytes."""
    X = np.random.RandomState(0).randn(300, 4).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, 300).astype(np.float32)
    t, bounds = _aft_labels()
    out = {}
    for key, params, label, kw in (("mc", _MC, y, {}),
                                   ("aft", _AFT, t, bounds)):
        bst = xgbt.train(params, xgbt.DMatrix(X, label, device="cpu", **kw),
                         2, verbose_eval=False)
        out[key] = (bst.save_raw(), params, X, label, kw)
    return out


def _meta_case(case):
    raw, params, X, y, bounds = case
    card = xgbt.Booster(model_file=raw, device="cpu")
    card.set_param(params)
    return card, _on_meta(card, xgbt.DMatrix(X, y, device="cpu", **bounds))


def test_multiclass_booster_walks_kernel_b_with_its_groups(
        cpu_models, stub_cuda, monkeypatch):
    from xgboost_tpu_torch.metric.multiclass import MultiLogLoss

    card, d = _meta_case(cpu_models["mc"])
    seen = []
    monkeypatch.setattr(MultiLogLoss, "evaluate",
                        lambda self, p, lab, w=None, **kw:
                        seen.append((p.device.type, tuple(p.shape))) or 0.0)
    assert card.eval_values([(d, "val")]) == {"val": {"mlogloss": 0.0}}
    assert seen == [("meta", (300, 3))]
    (name, args), = stub_cuda.calls
    # (X, n, F, nodes, tree_group, tree_weight, T, N, max_depth, G, ...)
    assert name == "xgbt_predict_margin" and args[6] == 6 and args[9] == 3
    boosted = []
    monkeypatch.setattr(card, "_boost",
                        lambda dm, g, h, i: boosted.append((g, h)))
    card.update(d, 2)
    (g, h), = boosted
    assert g.device.type == h.device.type == "meta"
    assert tuple(g.shape) == tuple(h.shape) == (300, 3)
    assert [c[0] for c in stub_cuda.calls] == ["xgbt_predict_margin"] * 2
    assert stub_cuda.calls[-1][1][9] == 3


def test_label_bounds_stay_on_the_data_device(cpu_models, stub_cuda,
                                              monkeypatch):
    card, d = _meta_case(cpu_models["aft"])
    assert d.label_lower_bound.device.type == "meta"
    got = []
    real = card._obj.get_gradient

    def spy(m, lab, w, it, *, label_lower=None, label_upper=None, **kw):
        got.append((label_lower.device.type, label_upper.device.type))
        return real(m, lab, w, it, label_lower=label_lower,
                    label_upper=label_upper, **kw)

    monkeypatch.setattr(card._obj, "get_gradient", spy)
    boosted = []
    monkeypatch.setattr(card, "_boost",
                        lambda dm, g, h, i: boosted.append((g, h)))
    card.update(d, 2)
    assert got == [("meta", "meta")]
    (g, h), = boosted
    assert g.device.type == h.device.type == "meta"
    assert [c[0] for c in stub_cuda.calls] == ["xgbt_predict_margin"]


@pytest.mark.parametrize("objective", ["rank:pairwise", "rank:ndcg",
                                       "rank:map"])
def test_ranking_objectives_are_not_ported(objective):
    """The ranking objectives train on the data's device (the CPU here)
    with query groups, and their gradients stay there. (The name dates
    from before ranking was ported, when this test checked that it
    raised.)"""
    X = np.random.RandomState(0).rand(8, 2).astype(np.float32)
    d = xgbt.DMatrix(X, np.arange(8) % 3, group=[4, 4], device="cpu")
    bst = xgbt.train({"objective": objective}, d, 1, verbose_eval=False)
    assert bst.num_boosted_rounds() == 1
    g, h = bst._obj.get_gradient(d.data[:, 0], d.label, None,
                                 groups=d.groups)
    assert g.device == h.device == d.device and g.dtype == torch.float32


@pytest.mark.parametrize("max_leaves", [3, 70])
def test_lossguide_steps_reach_the_level_kernel_at_d0(stub_cuda, max_leaves):
    """A lossguide tree on device tensors builds its root's and every
    expansion step's child histograms through kernel A at ``d = 0``,
    ``Kp = 0`` (no routing) and ``K = 2 * K_EXP`` (``K = 1`` at the
    root), over the feature-major bins; never the plain version."""
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree import grow_lossguide as tlg

    n, F, B = 300, 5, 16
    meta = dict(device="meta")
    bins = torch.empty((n, F), dtype=torch.uint8, **meta)
    cuts = torch.empty((F, B), **meta)
    g, h = torch.empty(n, **meta), torch.empty(n, **meta)
    before = thk.fused_level.launches
    tree = tlg.grow_tree_lossguide(bins, g, h, cuts,
                                   tgrow.GrowParams(max_depth=0), max_leaves,
                                   bins_t=thk.feature_major(bins))
    steps = tlg.lossguide_steps(max_leaves)
    kexp = tlg.expansions_per_step(max_leaves)
    assert thk.fused_level.launches == before + 1 + steps
    calls, scans = _split_calls(stub_cuda.calls)
    assert [c[0] for c in calls] == ["xgbt_fused_level"] * (1 + steps)
    assert scans == 2 * (1 + steps)  # with_missing and eval_splits a step
    # (bins, bin_bytes, n, F, B, pos, pos_out, q, ptab, W, Kp, prev_offset,
    #  K, offset, hist, bins_t, ...)
    ks = [args[12] for _, args in calls]
    assert ks == [1] + [2 * kexp] * steps
    for _, args in calls:
        assert args[1:5] == (1, n, F, B)
        assert args[9:12] == (4, 0, 0) and args[13] == 0
    assert tree.positions.device.type == "meta"
    assert tuple(tree.left.shape) == (2 * max_leaves - 1,)


@pytest.mark.parametrize("max_depth", [1, 4])
def test_local_levels_reach_the_level_kernel_at_d0(stub_cuda, max_depth):
    """A ``grow_local_histmaker`` tree on device tensors sketches, bins and
    routes every level on the device, its node totals included (nothing
    is read back: ``meta`` tensors cannot be), and builds its histogram
    through kernel A at ``d = 0``, ``Kp = 0`` (no routing) and
    ``K = 2^d``, over that level's int16 bins (``max_bin`` 256) and their
    feature-major copy; never the plain version."""
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree import grow_local as tgl

    n, F, B = 300, 5, 256
    meta = dict(device="meta")
    X = torch.empty((n, F), **meta)
    g, h = torch.empty(n, **meta), torch.empty(n, **meta)
    before = thk.fused_level.launches
    tree = tgl.grow_tree_local(X, g, h, tgrow.GrowParams(max_depth=max_depth),
                               B, 0.3, 0.0)
    assert thk.fused_level.launches == before + max_depth
    calls, scans = _split_calls(stub_cuda.calls)
    assert [c[0] for c in calls] == ["xgbt_fused_level"] * max_depth
    assert scans == 2 * max_depth
    # (bins, bin_bytes, n, F, B, pos, pos_out, q, ptab, W, Kp, prev_offset,
    #  K, offset, hist, bins_t, ...)
    for d, (_, args) in enumerate(calls):
        assert args[1:5] == (2, n, F, B)
        assert args[9:14] == (4, 0, 0, 1 << d, 0)
    assert tree.delta.device.type == "meta" and tuple(tree.delta.shape) == (n,)


def _meta_rows(X):
    return torch.as_tensor(X).to("meta")


@pytest.mark.parametrize("case", ["numerical", "categorical", "deep_path",
                                  "multiclass"])
def test_shap_values_stay_on_the_data_device(case, monkeypatch):
    from xgboost_tpu_torch import interpret

    rng = np.random.RandomState(0)
    X = rng.randn(128, 4).astype(np.float32)
    X[:, 1] = rng.randint(0, 5, 128)
    y = (X[:, 0] + X[:, 1] > 2).astype(np.float32)
    kw, params = {}, {"max_depth": 3, "max_bin": 16}
    if case == "categorical":
        kw["feature_types"] = ["q", "c", "q", "q"]
    if case == "multiclass":
        params.update(objective="multi:softprob", num_class=3)
        y = (np.arange(128) % 3).astype(np.float32)
    if case == "deep_path":
        monkeypatch.setattr(interpret, "_TABLE_MAX_D", 1)
    bst = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu", **kw), 2,
                     verbose_eval=False)
    K = 3 if case == "multiclass" else 1
    Xm = _meta_rows(X)
    for approx in (False, True):
        out = interpret.contribs(bst, Xm, approx)
        assert out.device.type == "meta" and out.shape == (128, K, 5)
    out = interpret.interactions(bst, Xm)
    assert out.device.type == "meta" and out.shape == (128, K, 5, 5)


@pytest.mark.parametrize("params", [
    {"feature_selector": s} for s in ("cyclic", "shuffle", "random",
                                      "greedy", "thrifty")] + [
    {"updater": "shotgun"}])
def test_linear_weights_stay_on_the_data_device(params):
    from xgboost_tpu_torch.gbm import GBLinear

    meta = torch.device("meta")
    gbm = GBLinear(2, params, meta)
    X = torch.empty((100, 5), device=meta)
    g = torch.empty((100, 2), device=meta)
    gbm.boost_one_round(X, g, g, 3)
    assert gbm.weights.device == meta and gbm.weights.shape == (6, 2)
    base = torch.empty((100, 2), device=meta)
    assert gbm.predict(X, base).device == meta


def test_estimators_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((8, 2), np.float32)
    y = np.arange(8) % 2
    for name in ("XGBClassifier", "XGBRegressor", "XGBRFClassifier"):
        with pytest.raises(RuntimeError, match="cuda"):
            getattr(xgbt, name)(n_estimators=1).fit(X, y)
    with pytest.raises(RuntimeError, match="cuda"):
        xgbt.XGBRanker(n_estimators=1).fit(X, y, group=[8])
    est = xgbt.XGBClassifier(n_estimators=1, device="cpu").fit(X, y)
    assert est.get_booster().device.type == "cpu"


def test_import_loads_no_pandas_or_pyarrow():
    """The card's machine has neither: the adapters import them where a
    frame or a table arrives."""
    code = (
        "import sys\n"
        "import xgboost_tpu_torch\n"
        "import xgboost_tpu_torch.data.adapters\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('pandas', 'pyarrow')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.fixture
def cpu_paged(tmp_path):
    """A paged matrix written on the CPU: 3 pages of at most 128 rows (the
    last 44) of 5 features at max_bin 256 (int16, 9 bits a symbol)."""
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5).astype(np.float32)

    class It(xgbt.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self, input_data):
            if self.i:
                return 0
            input_data(data=X, label=X[:, 0] > 0)
            self.i = 1
            return 1
    d = xgbt.ExternalMemoryQuantileDMatrix(
        It(), cache_prefix=str(tmp_path / "c"), max_bin=256, page_rows=128,
        device="cpu")
    yield d._paged
    d._paged.cleanup()


@pytest.mark.parametrize("max_depth", [1, 3])
def test_paged_levels_reach_the_level_kernel_page_by_page(stub_cuda, cpu_paged,
                                                          max_depth):
    """A paged tree on device tensors sends every page's level to kernel
    A's wrapper (int16 bins of the page's rows, its feature-major copy),
    ``max_depth`` x 3 launches in level-major order; the pages are unpacked
    on the device and nothing comes back to the host."""
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree import grow_fused as tgf

    meta = dict(device="meta")
    n, F, B = 300, 5, 256
    g, h = torch.empty(n, **meta), torch.empty(n, **meta)
    cuts = torch.empty((F, B), **meta)
    before = thk.fused_level.launches
    tree = tgf.grow_tree_fused_paged(cpu_paged, g, h, cuts, 0.3, 0.0,
                                     tgrow.GrowParams(max_depth=max_depth))
    assert thk.fused_level.launches == before + 3 * max_depth
    calls, scans = _split_calls(stub_cuda.calls)
    assert [c[0] for c in calls] == ["xgbt_fused_level"] * (3 * max_depth)
    assert scans == 2 * max_depth  # a level's scans, over all its pages
    # (bins, bin_bytes, n, F, B, pos, pos_out, q, ptab, W, Kp, prev_offset,
    #  K, offset, ...)
    for i, (_, args) in enumerate(calls):
        d, k = divmod(i, 3)
        assert args[1:5] == (2, cpu_paged.rows_of(k), F, B)
        assert args[12] == 1 << d
    assert tree.delta.device.type == "meta" and tuple(tree.delta.shape) == (n,)
    assert cpu_paged.io["prefetched"] > 0


def test_csr_inplace_predict_reaches_the_walk_kernel(cpu_models, stub_cuda):
    """CSR rows are made dense on the host a block of 65,536 rows at a time
    and each block goes to kernel B's wrapper on the device."""
    import scipy.sparse as sp

    card, _ = _meta_case(cpu_models["mc"])
    rows = sp.random(70_000, 4, density=0.5, format="csr", random_state=0,
                     dtype=np.float32)
    with pytest.raises(NotImplementedError, match="meta"):
        card.inplace_predict(rows, predict_type="margin")  # no data to read
    calls = stub_cuda.calls
    assert [c[0] for c in calls] == ["xgbt_predict_margin"] * 2
    # (X, n, F, ...)
    assert [c[1][1:3] for c in calls] == [(65_536, 4), (4_464, 4)]


# ---------------------------------------------------------------------------
# distributed training (collective.py, parallel/*)
# ---------------------------------------------------------------------------

DIST_MODULES = ("xgboost_tpu_torch.collective", "xgboost_tpu_torch.parallel",
                "xgboost_tpu_torch.parallel.mesh",
                "xgboost_tpu_torch.parallel.grow",
                "xgboost_tpu_torch.parallel.sketch")


def test_distributed_modules_import_no_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in DIST_MODULES) +
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


OBS_MODULES = ("xgboost_tpu_torch.observability",
               "xgboost_tpu_torch.observability.metrics",
               "xgboost_tpu_torch.observability.trace",
               "xgboost_tpu_torch.observability.flight",
               "xgboost_tpu_torch.observability.comms",
               "xgboost_tpu_torch.utils", "xgboost_tpu_torch.utils.log",
               "xgboost_tpu_torch.utils.timer",
               "xgboost_tpu_torch.utils.fault")


def test_observability_modules_import_no_jax():
    """The telemetry layer (its own copy of the registry included) imports
    neither ``jax`` nor ``xgboost_tpu``, and importing it initialises no
    CUDA context."""
    for m in OBS_MODULES:
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        assert path in set((ROOT / "xgboost_tpu_torch").rglob("*.py")), m
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in OBS_MODULES) +
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def test_spans_and_records_read_no_tensor(stub_cuda, monkeypatch, tmp_path):
    """A traced, flight-recorded tree on device tensors (``meta``: nothing
    can be read back) goes through the same kernel wrapper calls as an
    untraced one: a span or a record never reads a tensor, synchronises
    or launches."""
    from xgboost_tpu_torch.observability import RECORDER, trace
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree import grow_fused as tgf

    def synchronize(*a, **k):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    n, F, B, depth = 300, 5, 16, 3
    meta = dict(device="meta")

    def grow():
        RECORDER.begin_round(0)
        tgf.grow_tree_fused(
            torch.empty((n, F), dtype=torch.uint8, **meta),
            torch.empty(n, **meta), torch.empty(n, **meta),
            torch.empty((F, B), **meta), 0.3, 0.0,
            tgrow.GrowParams(max_depth=depth))
        RECORDER.end_round()

    grow()
    untraced = list(stub_cuda.calls)
    stub_cuda.calls.clear()
    monkeypatch.setenv("XGBTPU_TRACE", str(tmp_path / "t.json"))
    trace.reset()
    grow()
    level, scans = _split_calls(untraced)
    assert stub_cuda.calls == untraced and len(level) == depth
    assert scans == 2 * depth
    trace.flush()
    spans = [e for e in trace.load_trace(str(tmp_path / "t.json"))
             if e.get("ph") == "X"]
    assert [e["name"] for e in spans if e.get("cat") != "step"] == \
        ["grow_tree"]
    # the traced tree's step seam: a span per op, sub-op and scan
    steps = sorted(e["name"] for e in spans if e.get("cat") == "step")
    lu = ["step/level_update/" + s for s in ("eval_splits", "heap_write",
                                             "scan", "scan", "with_missing")]
    assert steps == sorted(
        ["step/prep", "step/level_partition", "step/finalize",
         "step/leaf_delta"]
        + depth * (["step/level_hist", "step/level_update"] + lu))
    trace.reset()
    RECORDER.reset()


def test_init_distributed_without_a_card_raises(monkeypatch, tmp_path):
    """Without ``device="cpu"`` and without a card, ``init_distributed``
    raises before any rendezvous (a world of two would otherwise wait for
    its second rank), the elastic route (``form_world``) included."""
    import torch.distributed as dist

    from xgboost_tpu_torch.parallel import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(f"file://{tmp_path}/pg", 2, 0)
    with pytest.raises(RuntimeError, match="is_available"):
        init_distributed(f"file://{tmp_path}/pg", 2, 0, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed("localhost:1", 2, 0, elastic=True)
    assert not dist.is_initialized()


@pytest.mark.parametrize("route", ["construct", "hoisted"])
def test_group_histograms_reach_the_kernels_and_reduce_on_the_device(
        stub_cuda, monkeypatch, route):
    """Under a row group, a tree on device tensors sends every level to
    kernel A's (construct) or kernel D's (hoisted) wrapper, and what goes
    to ``torch.distributed.all_reduce`` is on that device: the gradient
    scale (float32 [2], MAX), the root totals (int64 [2], SUM) and each
    level's int64 ``[F, 2K, B]`` histogram (SUM), never a CPU copy."""
    import torch.distributed as dist

    from xgboost_tpu_torch.parallel import RowGroup
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree import grow_fused as tgf

    seen = []

    def spy(t, op=None, group=None):
        seen.append((t.device.type, t.dtype, tuple(t.shape), op, group))

    monkeypatch.setattr(dist, "all_reduce", spy)
    group = RowGroup(group="device group", host_group="host group", rank=0,
                     world_size=2, device=torch.device("meta"),
                     backend="gloo")
    meta = dict(device="meta")
    n, F, B, depth = 300, 5, 16, 3
    onehot = (torch.empty((F * B, thk.onehot_rows(n)), dtype=torch.int8,
                          **meta) if route == "hoisted" else None)
    tree = tgf.grow_tree_fused(
        torch.empty((n, F), dtype=torch.uint8, **meta),
        torch.empty(n, **meta), torch.empty(n, **meta),
        torch.empty((F, B), **meta), 0.3, 0.0,
        tgrow.GrowParams(max_depth=depth), onehot=onehot, group=group)
    kernel = "xgbt_fused_level" if route == "construct" \
        else "xgbt_hoisted_level"
    calls, scans = _split_calls(stub_cuda.calls)
    assert [c[0] for c in calls] == [kernel] * depth and scans == 2 * depth
    assert seen[0] == ("meta", torch.float32, (2,), dist.ReduceOp.MAX,
                       "device group")
    assert seen[1] == ("meta", torch.int64, (2,), dist.ReduceOp.SUM,
                       "device group")
    assert seen[2:] == [("meta", torch.int64, (F, 2 << d, B),
                         dist.ReduceOp.SUM, "device group")
                        for d in range(depth)]
    assert tree.delta.device.type == "meta"


RESILIENCE_MODULES = ("xgboost_tpu_torch.resilience",
                      "xgboost_tpu_torch.resilience.policy",
                      "xgboost_tpu_torch.resilience.chaos",
                      "xgboost_tpu_torch.resilience.watchdog",
                      "xgboost_tpu_torch.resilience.checkpoint")


def test_resilience_modules_and_resume_import_no_jax(tmp_path):
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in RESILIENCE_MODULES) +
        "import numpy as np\n"
        "import xgboost_tpu_torch as xgbt\n"
        "from xgboost_tpu_torch.resilience import chaos\n"
        "X = np.random.RandomState(0).randn(200, 3).astype(np.float32)\n"
        "d = xgbt.DMatrix(X, (X[:, 0] > 0).astype(np.float32), device='cpu')\n"
        "with chaos.configure('checkpoint_write:transient:1'):\n"
        f"    xgbt.train({{'max_depth': 2}}, d, 2, resume_from={str(tmp_path)!r})\n"
        f"bst = xgbt.train({{'max_depth': 2}}, d, 3, resume_from={str(tmp_path)!r})\n"
        "assert bst.num_boosted_rounds() == 3\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_pallas_chaos_on_a_device_tensor_raises_before_any_launch(
        stub_cuda):
    from xgboost_tpu_torch.resilience import chaos

    n, F, T, N = 50, 4, 3, 7
    meta = dict(device="meta")
    forest = tpred.StackedForest(
        left=torch.empty((T, N), dtype=torch.int32, **meta),
        right=torch.empty((T, N), dtype=torch.int32, **meta),
        feature=torch.empty((T, N), dtype=torch.int32, **meta),
        cond=torch.empty((T, N), dtype=torch.float32, **meta),
        default_left=torch.empty((T, N), dtype=torch.bool, **meta),
        tree_group=torch.empty(T, dtype=torch.int32, **meta),
        max_depth=2, n_groups=1, num_feature=F)
    X = torch.empty((n, F), dtype=torch.float32, **meta)
    before = tpred.predict_margin.launches
    with chaos.configure("pallas:permanent:1"):
        with pytest.raises(chaos.ChaosPermanent):
            tpred.predict_margin(forest, X, torch.empty((n, 1), **meta))
    assert tpred.predict_margin.launches == before
    assert stub_cuda.calls == []


# ---------------------------------------------------------------------------
# elastic training and the command line
# ---------------------------------------------------------------------------

ELASTIC_MODULES = ("xgboost_tpu_torch.parallel.membership",
                   "xgboost_tpu_torch.cli",
                   "xgboost_tpu_torch.observability.fleet",
                   "xgboost_tpu_torch.observability.report")


def test_elastic_and_cli_modules_import_no_jax():
    for m in ELASTIC_MODULES + ("xgboost_tpu_torch.__main__",):
        path = ROOT / (m.replace(".", "/") + ".py")
        assert path in set((ROOT / "xgboost_tpu_torch").rglob("*.py")), m
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in ELASTIC_MODULES) +
        "from xgboost_tpu_torch import elastic_exit, elastic_train\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_heartbeat_agent_imports_only_the_standard_library():
    """The agent subprocess carries its own chaos predicate: it imports
    neither the package nor torch (nor jax)."""
    from xgboost_tpu_torch.parallel.membership import _AGENT_SRC

    names = set()
    for node in ast.walk(ast.parse(_AGENT_SRC)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names == {"json", "os", "sys", "time", "zlib"}, names


# ---------------------------------------------------------------------------
# serving (predictor/serving.py, serving/*)
# ---------------------------------------------------------------------------

SERVING_MODULES = ("xgboost_tpu_torch.predictor.serving",
                   "xgboost_tpu_torch.serving",
                   "xgboost_tpu_torch.serving.admission",
                   "xgboost_tpu_torch.serving.batcher",
                   "xgboost_tpu_torch.serving.delivery",
                   "xgboost_tpu_torch.serving.faults",
                   "xgboost_tpu_torch.serving.obs",
                   "xgboost_tpu_torch.serving.server",
                   "xgboost_tpu_torch.serving.swap",
                   "xgboost_tpu_torch.serving.tenancy")


def test_serving_modules_import_no_jax():
    for m in SERVING_MODULES:
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        assert path.exists(), m
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in SERVING_MODULES) +
        "from xgboost_tpu_torch import ModelServer, RequestError, "
        "RequestShed\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'xgboost_tpu_torch.resilience.degrade' not in sys.modules\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_model_server_defaults_to_cuda_and_raises_without_it(monkeypatch):
    import threading

    from xgboost_tpu_torch.serving import ModelRegistry, ModelServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="cuda"):
        ModelServer()
    with pytest.raises(RuntimeError, match="cuda"):
        ModelRegistry()
    assert threading.active_count() == threads  # no worker was started
    ModelServer(device="cpu").close()


def test_served_dispatch_reaches_the_walk_kernel(cpu_models, stub_cuda):
    """A served dispatch on a device goes to kernel B's wrapper, once per
    coalesced dispatch, never to the plain version; what fails after the
    launch (the stub device has no data to copy back) comes back as the
    typed ``RequestError``, with no other route tried."""
    from xgboost_tpu_torch.serving import ModelServer, RequestError

    card, _ = _meta_case(cpu_models["mc"])
    meta = torch.device("meta")
    srv = ModelServer(device="cpu", batch_wait_us=0)
    try:
        srv.device = srv.registry.device = srv.batcher.device = meta
        srv.load("m", card, warm=False)
        assert srv.registry.get("m").booster is card
        rows = np.random.RandomState(0).randn(7, 4).astype(np.float32)
        fut = srv.predict_async("m", rows, predict_type="margin")
        with pytest.raises(RequestError, match="meta"):
            fut.result(60)
    finally:
        srv.close()
    calls = stub_cuda.calls
    assert [c[0] for c in calls] == ["xgbt_predict_margin"]
    # (X, n, F, node records, tree_group, tree_weight, T, N, max_depth, G,
    #  base, out, stream)
    assert calls[0][1][1:3] == (7, 4) and calls[0][1][9] == 3


def test_batcher_worker_makes_the_servers_card_current(monkeypatch):
    """The batcher's worker thread (a new thread starts on card 0) makes
    the server's card current before its first launch, with the card's
    index resolved where the server was made."""
    import threading

    from xgboost_tpu_torch.serving.batcher import MicroBatcher

    seen = []
    ready = threading.Event()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: (seen.append(d), ready.set()))
    mb = MicroBatcher(device="cuda")
    try:
        assert ready.wait(30)
        assert seen == [torch.device("cuda", 3)] and mb.device.index == 3
    finally:
        mb.close()


def test_batcher_close_serves_leftovers_on_the_servers_card(monkeypatch):
    """A request still queued when the worker is gone is served by
    ``close(drain=True)`` on the closing thread, which makes the server's
    card current before that dispatch."""
    import threading

    from xgboost_tpu_torch.serving import batcher as bm

    seen, served = [], []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.append((threading.get_ident(), d)))
    monkeypatch.setattr(bm.MicroBatcher, "_loop", lambda self, gen: None)

    class Entry:
        name, label = "m", "m@v1"

        def predict(self, X, **kw):
            served.append(threading.get_ident())
            return np.zeros(len(X), np.float32)

        def release(self):
            pass

    mb = bm.MicroBatcher(device="cuda")
    mb._worker.join(30)
    req = bm._Request(Entry(), np.zeros((2, 3), np.float32), 2, ("k",),
                      "value", None, np.nan, None, None, None)
    mb._q.put(req)
    mb.close(drain=True)
    me = threading.get_ident()
    assert served == [me]
    assert seen == [(me, torch.device("cuda", 3))]
    assert req.future.result(5).shape == (2,)


# ---------------------------------------------------------------------------
# the serving fleet (serving/fleet/*, observability/serve_report.py)
# ---------------------------------------------------------------------------

FLEET_MODULES = ("xgboost_tpu_torch.serving.fleet",
                 "xgboost_tpu_torch.serving.fleet.hashring",
                 "xgboost_tpu_torch.serving.fleet.router",
                 "xgboost_tpu_torch.serving.fleet.supervisor",
                 "xgboost_tpu_torch.observability.serve_report")


def test_fleet_modules_import_no_jax():
    for m in FLEET_MODULES:
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        assert path.exists(), m
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in FLEET_MODULES) +
        "from xgboost_tpu_torch.serving import FleetSupervisor, HashRing, "
        "ReplicaEndpoint, Router, serve_fleet_main\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_JSONL_STUB = """
import json, socketserver, sys

class H(socketserver.StreamRequestHandler):
    def handle(self):
        for raw in self.rfile:
            msg = json.loads(raw)
            if msg.get("op") == "ping":
                out = {"ok": True, "draining": False}
            else:
                out = {"id": msg.get("id"), "result": [0.5], "version": "m@v1"}
            self.wfile.write((json.dumps(out) + "\\n").encode())
            self.wfile.flush()

srv = socketserver.ThreadingTCPServer(("127.0.0.1", int(sys.argv[1])), H)
print("READY stub", flush=True)
srv.serve_forever()
"""


def test_fleet_parent_makes_no_cuda_call(tmp_path):
    """Supervisor and router spawn, probe, forward, broadcast and stop two
    line-protocol replicas with every ``torch.cuda`` entry that could make
    a context replaced by one that fails the run."""
    stub = tmp_path / "stub.py"
    stub.write_text(_JSONL_STUB)
    code = (
        "import sys, torch\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('the fleet parent called torch.cuda')\n"
        "for name in ('is_available', 'init', '_lazy_init', 'set_device',\n"
        "             'current_device', 'device_count', 'synchronize'):\n"
        "    setattr(torch.cuda, name, boom)\n"
        "from xgboost_tpu_torch.serving.fleet import FleetSupervisor, Router\n"
        "router = Router(health_interval_s=0.05).start()\n"
        f"sup = FleetSupervisor({str(tmp_path / 'run')!r}, replicas=2,\n"
        f"    spawn_cmd=lambda rid, port: [sys.executable, {str(stub)!r},\n"
        "                                 str(port)], router=router).start()\n"
        "r = router.handle({'op': 'predict', 'id': 'q', 'model': 'm',\n"
        "                   'data': [[1.0, 2.0]]})\n"
        "assert r == {'id': 'q', 'result': [0.5], 'version': 'm@v1'}, r\n"
        "r = router.handle({'op': 'load', 'model': 'm', 'path': 'x'})\n"
        "assert r['ok'] and r['replicas'] == ['r0', 'r1'], r\n"
        "assert all(x['healthy'] for x in\n"
        "           router.handle({'op': 'stats'})['stats']['replicas'])\n"
        "sup.stop(drain_timeout_s=5)\n"
        "router.stop()\n"
        "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serve_fleet_without_a_card_fails_at_once(tmp_path, monkeypatch):
    """``serve-fleet`` without ``--device``: each replica asks for the
    card; with none, the first replica raises before READY and the command
    exits 1 within seconds (not after the 180 s READY wait), its log
    holding the replica's error."""
    from xgboost_tpu_torch.serving.fleet import serve_fleet_main

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    t0 = time.monotonic()
    assert serve_fleet_main(["--port", "0", "--run-dir", str(tmp_path),
                             "--replicas", "2"]) == 1
    assert time.monotonic() - t0 < 90
    with open(tmp_path / "replica0" / "serve.log") as f:
        assert "torch.cuda.is_available() is False" in f.read()
    assert not (tmp_path / "replica1").exists()


# ---------------------------------------------------------------------------
# the pipelined round loop (pipeline.py, utils/observer.py, the async writer)
# ---------------------------------------------------------------------------

PIPELINE_MODULES = ("xgboost_tpu_torch.pipeline",
                    "xgboost_tpu_torch.utils.observer",
                    "xgboost_tpu_torch.resilience.checkpoint")


def test_pipeline_modules_import_no_jax(tmp_path):
    for m in PIPELINE_MODULES:
        assert (ROOT / (m.replace(".", "/") + ".py")).exists(), m
    code = (
        "import os, sys\n"
        + "".join(f"import {m}\n" for m in PIPELINE_MODULES) +
        f"os.environ['XGBTPU_OBSERVER'] = {str(tmp_path / 'obs')!r}\n"
        "os.environ['XGBTPU_PIPELINE_DEPTH'] = '2'\n"
        "import numpy as np\n"
        "import xgboost_tpu_torch as xgbt\n"
        "X = np.random.RandomState(0).randn(200, 3).astype(np.float32)\n"
        "d = xgbt.DMatrix(X, (X[:, 0] > 0).astype(np.float32), device='cpu')\n"
        f"bst = xgbt.train({{'max_depth': 2}}, d, 2, resume_from={str(tmp_path / 'ck')!r})\n"
        "bst.update_many(d, 2, 2)\n"
        "bst._pipeline.drain()\n"
        f"assert len(os.listdir({str(tmp_path / 'obs')!r})) == 12\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


NATIVE = ROOT / "xgboost_tpu_torch" / "native"


def test_native_modules_import_no_jax(tmp_path):
    files = sorted(NATIVE.glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "capi.py"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if _forbidden(n)], (path, names)
    data = tmp_path / "d.libsvm"
    data.write_text("1 0:1.5 junk 2:3\n0 1:2\n")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import xgboost_tpu_torch as xgbt\n"
        "from xgboost_tpu_torch.native import capi\n"
        f"d = xgbt.DMatrix({str(data)!r}, device='cpu')\n"
        "assert d.num_row() == 2\n"
        "class It(xgbt.DataIter):\n"
        "    def __init__(self):\n"
        "        super().__init__(); self.i = 0\n"
        "    def reset(self): self.i = 0\n"
        "    def next(self, input_data):\n"
        "        if self.i == 2: return 0\n"
        "        X = np.random.RandomState(self.i).randn(300, 3)\n"
        "        input_data(data=X, label=(X[:, 0] > 0) * 1.0)\n"
        "        self.i += 1; return 1\n"
        f"m = xgbt.ExternalMemoryQuantileDMatrix(It(), cache_prefix={str(tmp_path / 'c')!r}, max_bin=16, page_rows=256, device='cpu')\n"
        "xgbt.train({'max_depth': 2, 'max_bin': 16}, m, 2)\n"
        "assert m._paged.io['reads'] > 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'xgboost_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_c_api_imports_only_numpy_json_and_the_port():
    import re

    src = (NATIVE / "c_api.cpp").read_text()
    names = re.findall(r'\bimp\(\s*"([^"]+)"', src)
    assert names, "c_api.cpp names no module"
    # every import of the C source goes through imp()
    assert len(re.findall(r"PyImport_\w+\(", src)) == 1
    assert "PyRun_" not in src
    for name in names:
        assert name in ("numpy", "json") or name.split(".")[0] == \
            "xgboost_tpu_torch", name


def test_native_build_failure_raises_with_no_fallback(tmp_path, monkeypatch):
    """``CXX=false``: every loader and builder raises; neither the plain
    parsers nor ``np.fromfile`` run."""
    from xgboost_tpu_torch import native
    from xgboost_tpu_torch.data import adapters
    from xgboost_tpu_torch.data.external import PagedBins

    def never(*a, **k):
        raise AssertionError("a fallback ran")

    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    for name in ("_load_svmlight_py", "_load_csv_py"):
        monkeypatch.setattr(adapters, name, never)
    monkeypatch.setattr(np, "fromfile", never)
    monkeypatch.setattr(np, "loadtxt", never)
    data = tmp_path / "d.libsvm"
    data.write_text("1 0:1.5\n")
    (tmp_path / "d.csv").write_text("1,2\n")
    for fn, arg in ((adapters.load_svmlight, data),
                    (adapters.load_csv, tmp_path / "d.csv"),
                    (xgbt.DMatrix, str(data))):
        with pytest.raises(RuntimeError, match="native build of fastparse"):
            fn(arg) if fn is not xgbt.DMatrix else fn(arg, device="cpu")
    X = np.random.RandomState(0).randn(64, 3).astype(np.float32)
    cuts = xgbt.DMatrix(X, device="cpu").get_binned(16).cuts
    pg = PagedBins(str(tmp_path / "p"), cuts, 64, 3, 32, np.uint8)
    with pytest.raises(RuntimeError, match="native build of pagecache"):
        pg.write_page(0, np.zeros((32, 3), np.uint8))
    with pytest.raises(RuntimeError, match="native build of pagecache"):
        pg.read_page(0)
    with pytest.raises(RuntimeError, match="native build of capi"):
        native.build_capi()
    assert not list((tmp_path / "build").glob("*.so"))

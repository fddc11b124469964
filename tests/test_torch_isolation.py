"""The port stands alone and has no hidden CPU fallback.

- importing ``xgboost_tpu_torch`` loads neither ``jax`` nor ``xgboost_tpu``;
- no module of the package, nor ``chip_smoke.py`` or the port's profile
  script, imports either (AST);
- without a CUDA device, entry points that were not asked for the CPU
  raise;
- a tensor that is not on the CPU goes to the kernel wrapper (checked with
  a stub kernel library that records its calls), never to the plain
  version; a device with no kernel, or a failed build, raises.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch import _build
from xgboost_tpu_torch import predictor as tpred
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
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_round_profile.py"]
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


class _StubLib:
    """Records kernel entry-point calls; returns CUDA success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("xgbt_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return 0
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

    monkeypatch.setattr(thk, "_fused_level_plain", no_plain)
    monkeypatch.setattr(tpred, "_predict_margin_plain", no_plain)
    return lib


def test_device_tensor_reaches_the_level_kernel(stub_cuda):
    n, F, B, K, d = 300, 5, 16, 4, 2
    meta = dict(device="meta")
    bins = torch.empty((n, F), dtype=torch.uint8, **meta)
    pos = torch.empty((n, 1), dtype=torch.int32, **meta)
    gq = thk.QuantizedGradients(q=torch.empty((n, 2), dtype=torch.int32, **meta),
                                exp=torch.empty(2, dtype=torch.int32, **meta))
    ptab = torch.empty((2, 4), dtype=torch.float32, **meta)
    before = thk.fused_level.launches
    new_pos, hist = thk.fused_level(bins, pos, gq, ptab, K=K, Kp=2, B=B, d=d)
    assert thk.fused_level.launches == before + 1
    (name, args), = stub_cuda.calls
    assert name == "xgbt_fused_level"
    # (bins, n, F, B, pos, pos_out, q, ptab, Kp, prev_offset, K, offset, ...)
    assert args[1:4] == (n, F, B) and args[8:12] == (2, 1, K, 3)
    assert tuple(new_pos.shape) == (n, 1) and tuple(hist.shape) == (F, 2 * K, B)
    # the kernel reads uint8 bins only: wider storage raises, never falls back
    with pytest.raises(NotImplementedError):
        thk.fused_level(bins.to(torch.int16), pos, gq, ptab, K=K, Kp=2, B=B, d=d)


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
    assert args[1:3] == (n, F) and args[10:14] == (T, N, 2, 1)
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

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips (from a fixture, at run time) where
``torch.cuda.is_available()`` is False, as on a CPU-only test machine. On a
machine with a card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have). Shapes cover what ``chip_smoke.py`` does not: a
ragged row count, a level whose [2K, B] tile does not fit shared memory (the
kernel's device-memory path), every missing-bin case, multi-group forests
with tree weights and forests deeper than they are wide.
"""

import numpy as np
import pytest
import torch

from xgboost_tpu_torch import predictor as tpred
from xgboost_tpu_torch.tree import hist_kernel as thk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _level_case(rng, n, F, B, d, dev):
    K, Kp = 1 << d, (1 << d) >> 1
    bins = rng.randint(0, B + 1, size=(n, F)).astype(np.uint8)
    g = rng.randn(n).astype(np.float32)
    h = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    pos = rng.randint(max((1 << max(d - 1, 0)) - 1, 0), (1 << d) - 1 + 1,
                      size=(n, 1)).astype(np.int32) if d else \
        np.zeros((n, 1), np.int32)
    ptab = np.stack([(rng.rand(max(Kp, 1)) < 0.8), rng.randint(0, F, max(Kp, 1)),
                     rng.randint(0, B, max(Kp, 1)),
                     rng.rand(max(Kp, 1)) < 0.5], axis=1).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    gq = thk.quantize_gradients(t(g), t(h))
    return t(bins), t(pos), gq, t(ptab), dict(K=K, Kp=Kp, B=B, d=d)


@pytest.mark.parametrize("n,F,B,d", [
    (1, 3, 16, 0),          # one row
    (1000, 7, 16, 3),       # ragged rows, small tile
    (5000, 50, 64, 5),      # the main path's width at K = 32
    (3000, 9, 254, 7),      # [2K, B] int64 tile > 227 KB: device-memory path
])
def test_level_kernel_matches_plain_bitwise(cuda, n, F, B, d):
    rng = np.random.RandomState(n + d)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, d, cuda)
    pk, hk = thk._fused_level_cuda(bins, pos, gq, ptab, **kw)
    pk2, hk2 = thk._fused_level_cuda(bins, pos, gq, ptab, **kw)
    pp, hp = thk._fused_level_plain(bins, pos, gq, ptab, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    assert torch.equal(hk, hp)
    assert torch.equal(pk2, pk) and torch.equal(hk2, hk)


@pytest.mark.parametrize("T,depth,G,n,F", [
    (1, 1, 1, 1, 2),
    (7, 3, 2, 1000, 5),
    (20, 8, 3, 3000, 300),  # X rows too wide to stage in shared memory
])
def test_walk_kernel_matches_plain(cuda, T, depth, G, n, F):
    rng = np.random.RandomState(T + n)
    N = (1 << (depth + 1)) - 1
    internal = (1 << depth) - 1
    idx = np.arange(N)
    left = np.tile(np.where(idx < internal, 2 * idx + 1, -1), (T, 1))
    right = np.tile(np.where(idx < internal, 2 * idx + 2, -1), (T, 1))
    # cut some subtrees short: a leaf in the middle of the heap
    left[:, 2] = right[:, 2] = -1
    forest = tpred.forest_from_numpy(
        left, right, rng.randint(0, F, size=(T, N)),
        rng.randn(T, N).astype(np.float32), rng.rand(T, N) < 0.5,
        rng.randint(0, G, size=T), depth, G, device=cuda)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.1] = np.nan
    X = torch.as_tensor(X, device=cuda)
    base = torch.as_tensor(rng.randn(n, G).astype(np.float32), device=cuda)
    tw = torch.as_tensor(rng.uniform(0.5, 2.0, T).astype(np.float32),
                         device=cuda)
    got = tpred._predict_margin_cuda(forest, X, base, tw)
    want = tpred._predict_margin_plain(forest, X, base, tw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips (from a fixture, at run time) where
``torch.cuda.is_available()`` is False, as on a CPU-only test machine. On a
machine with a card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have). Shapes cover what ``chip_smoke.py`` does not: a
ragged row count, a level whose [2K, B] tile does not fit shared memory
(node slices), every missing-bin case, multi-group forests
with tree weights and forests deeper than they are wide; for kernels C and
D (the hoisted route) ragged row counts, K = 1 and K = 128 (two and more
slot blocks), bins 16/64/256 and a partial hoist of 4 features. Kernel D
also at 1M rows, where a block runs 23 or 45 stages of 128 rows on 132 SMs
(the last block fewer), far more than the 4 slots of its cp.async ring (the
ring wraps), and the last stage is ragged; B = 100 (uint8) and B = 255 (int16), whose
64-column tiles straddle feature boundaries, full and partial hoist; a
single construct feature (Fh = F - 1); and quantised gradients at the
quantiser's extremes (|q| up to 2^30, both signs). Its routing launch's
channel records are held bitwise against ``_channel_records_plain``.

Kernel A's cases since its redesign (routing once per level, feature-major
bins, 32-bit halves in node-sliced shared tiles): every row in one bin at
K = 1 (every add of a warp on one address); levels whose [2K, B] tile is
cut into node slices (uneven last slice) with a ragged last row chunk;
more than 2^16 rows, so the halves' per-block cap splits the rows, with
every row's |q| at the quantiser's extremes in one cell; a bin count whose
single node does not fit shared memory (the device-memory path); its
routing launch's records against ``_level_records_plain``. Kernel B's:
500 trees over many shared-memory chunks (X staged), tree counts that
leave a tail of single walks, three groups with tree weights, seven
groups of a 10-round 7-class model's own forest (interleaved
``tree_info``), forests
deep enough to walk from device memory, and non-heap forests (node ids
permuted, as JSON models number them) with leaves mid-tree; and one input of
just over 2^31 elements (43M rows x 50), which the wrapper walks in two
row chunks, equal to the plain walk on rows at both sides of the chunk
boundary and of the 2^31st element.

SHAP and the linear booster (``-k "shap or gblinear"``): contributions,
Saabas and interactions of CPU-trained models (depth 6, categorical, 3
classes, lossguide, the row DP) on the card and the CPU within 1e-9; the
linear booster's weights for every selector within rtol 1e-6.

The other tree methods (``-k "exact or wide or local or method"``):
kernel A at B = 16,001 (the global-memory branch) and 7,175, kernels C
and D at B = 7,175 with a partial hoist, a local histmaker tree, and 3
rounds of ``approx``, ``exact`` and the local histmaker followed by a
refresh, each the same bits on the card and the CPU. The rounding repairs
(``-k "cuts or off_power or node_totals"``): ``compute_cuts`` at max_bin
37, 100 and 1000 with unit and hessian-like weights, local histmaker trees
at max_bin 37 and 100 on continuous hessians, and the local histmaker's
node totals (up to 1M rows a node), card == CPU bitwise.

Sparse input and external memory (``-k "paged or csr"``): kernel A on
every page of a paged matrix (unpacked on the card) at every level of a
depth-6 tree, bitwise its plain version, the pages' histograms summing to
the whole matrix's; paged trees equal to the streaming matrix's and to the
CPU's; CSR ``inplace_predict`` and CSR training equal to dense.

Distributed training (``-k distributed``): two ranks over gloo on the
card and two on the CPU, 3 rounds at 64k rows in ragged shards on shared
cuts, give the same model bytes and trees (the workers are
``tests/test_torch_distributed.py``'s).

Serving (``-k serving``): a model server on the card coalesces 64 queued
one-row requests into one dispatch, one kernel B launch, whose answers
equal the plain version's on the CPU bit for bit.

The strict-order scan, kernel S (``-k scan``): ``seq_cumsum`` on the card
bit for bit the plain loop's at the level shapes ``[2, K, F, B]`` (d =
0-5, F = 50 and 136, B = 256), 4 lanes, B = 64, 7,175 and 16,001 and
ragged rows, with -0.0, infinities, NaN and subnormals in the rows; the
wrapper's refusals; ``_level_update``'s heap equal on the card and the
CPU; 12 launches in a depth-6 tree, whose model bytes equal the CPU's.

Categorical decision tables, ``[Kp, 5+B]`` (``-k categorical``): kernels A
and D and both routing launches with wide tables whose nodes mix numerical
and categorical splits, every bin id in some set and missing bins among
the rows, at bins 16/64/256, K up to 32, full and partial hoists, equal to
the plain versions and to each other; a table of any other width raises.
"""

import numpy as np
import pytest
import torch

from xgboost_tpu_torch import predictor as tpred
from xgboost_tpu_torch.tree import grow as tgrow
from xgboost_tpu_torch.tree import grow_fused as tgf
from xgboost_tpu_torch.tree import hist_kernel as thk
from xgboost_tpu_torch.tree.param import SplitParams as TSplitParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bin_dtype(B):
    return np.uint8 if B + 1 <= 255 else np.int16  # quantile.storage_dtype


def _level_case(rng, n, F, B, d, dev, categorical=False):
    K, Kp = 1 << d, (1 << d) >> 1
    bins = rng.randint(0, B + 1, size=(n, F)).astype(_bin_dtype(B))
    g = rng.randn(n).astype(np.float32)
    h = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    pos = rng.randint(max((1 << max(d - 1, 0)) - 1, 0), (1 << d) - 1 + 1,
                      size=(n, 1)).astype(np.int32) if d else \
        np.zeros((n, 1), np.int32)
    ptab = np.stack([(rng.rand(max(Kp, 1)) < 0.8), rng.randint(0, F, max(Kp, 1)),
                     rng.randint(0, B, max(Kp, 1)),
                     rng.rand(max(Kp, 1)) < 0.5], axis=1).astype(np.float32)
    if categorical:  # [Kp, 5+B]: node 0 and about half the rest
        ptab = np.concatenate([
            ptab, (rng.rand(max(Kp, 1), 1) < 0.5),
            rng.rand(max(Kp, 1), B) < 0.4], axis=1).astype(np.float32)
        ptab[0, 0] = ptab[0, 4] = 1.0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    gq = thk.quantize_gradients(t(g), t(h))
    return t(bins), t(pos), gq, t(ptab), dict(K=K, Kp=Kp, B=B, d=d)


@pytest.mark.parametrize("n,F,B,d", [
    (1, 3, 16, 0),          # one row
    (1000, 7, 16, 3),       # ragged rows, small tile
    (5000, 50, 64, 5),      # the main path's width at K = 32
    (3000, 9, 254, 7),      # [2K, B] int64 tile > 227 KB: node slices
    (4001, 6, 256, 5),      # int16 bins at the default max_bin
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


@pytest.mark.parametrize("n,F,B,Fh", [
    (1000, 7, 16, 7),       # ragged rows, uint8, several features per tile
    (777, 5, 64, 3),        # partial, ragged
    (3001, 6, 256, 4),      # int16 bins, partial hoist of 4 features
])
def test_onehot_kernel_matches_plain_bitwise(cuda, n, F, B, Fh):
    rng = np.random.RandomState(n + B)
    bins = torch.as_tensor(rng.randint(0, B + 1, size=(n, F)).astype(
        _bin_dtype(B)), device=cuda)
    got = thk._build_onehot_cuda(bins, B=B, Fh=Fh)
    want = thk._build_onehot_plain(bins, B=B, Fh=Fh)
    torch.cuda.synchronize()
    assert got.shape == (Fh * B, thk.onehot_rows(n))
    assert torch.equal(got, want)


def _extreme_gradients(rng, n, dev):
    """Quantised (g, h) at the quantiser's extremes: |q| within 512 of
    2^30, both signs, and exactly +-2^30."""
    big = 1 << 30
    q = rng.choice([-1, 1], size=(n, 2)) * (big - rng.randint(0, 512, (n, 2)))
    q[::7] = big
    q[3::7] = -big
    return thk.QuantizedGradients(
        q=torch.as_tensor(q.astype(np.int32), device=dev),
        exp=torch.zeros(2, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("n,F,B,Fh,d,extreme", [
    (1000, 7, 16, 7, 0, False),      # full hoist, K = 1, ragged rows
    (1000, 7, 16, 3, 3, False),      # partial hoist
    (2049, 5, 64, 5, 5, False),      # bin 64 full hoist at K = 32
    (999, 6, 64, 4, 7, False),       # K = 128: four slot blocks, partial
    (3001, 6, 256, 4, 5, False),     # int16 bins, partial hoist of 4
    (517, 5, 256, 5, 7, False),      # int16, full hoist, K = 128
    # the 4-slot ring wraps: by the launcher's sizing rule on 132 SMs, 23
    # and 45 stages of 128 rows per block (8 wrap it twice); 67 rows in the
    # last stage
    (1_000_003, 12, 64, 12, 0, False),
    (1_000_003, 6, 64, 3, 7, False),  # the same, partial hoist, K = 128
    (2500, 6, 100, 6, 4, False),     # tiles straddle features, full
    (2500, 6, 100, 3, 4, False),     # ... partial
    (1500, 5, 255, 5, 5, False),     # int16, straddling tiles, full
    (1500, 5, 255, 2, 5, False),     # ... partial
    (2000, 6, 64, 5, 3, False),      # one construct feature
    (4099, 6, 64, 4, 5, True),       # |q| near 2^30, partial hoist
    (1000, 5, 255, 5, 2, True),      # |q| near 2^30, int16, full hoist
])
def test_hoisted_kernel_matches_plain_and_level_kernel_bitwise(cuda, n, F, B,
                                                               Fh, d, extreme):
    rng = np.random.RandomState(n + d + B)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, d, cuda)
    if extreme:
        gq = _extreme_gradients(rng, n, cuda)
    onehot = thk._build_onehot_cuda(bins, B=B, Fh=Fh)
    pk, hk = thk._hoisted_level_cuda(bins, onehot, pos, gq, ptab, **kw)
    pk2, hk2 = thk._hoisted_level_cuda(bins, onehot, pos, gq, ptab, **kw)
    pp, hp = thk._hoisted_level_plain(bins, onehot, pos, gq, ptab, **kw)
    pa, ha = thk._fused_level_cuda(bins, pos, gq, ptab, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(pk, pa)
    assert torch.equal(hk, hp)
    assert torch.equal(hk, ha)
    assert torch.equal(pk2, pk) and torch.equal(hk2, hk)


@pytest.mark.parametrize("n,F,B,Fh,d,extreme", [
    (1000, 7, 16, 7, 0, False),      # full hoist: no unhoisted copy
    (3001, 6, 256, 4, 5, False),     # int16, partial hoist
    (2000, 6, 64, 5, 3, True),       # one construct feature, |q| ~ 2^30
])
def test_hoisted_route_launch_records_match_plain_bitwise(cuda, n, F, B, Fh,
                                                          d, extreme):
    rng = np.random.RandomState(n + d + B + 1)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, d, cuda)
    if extreme:
        gq = _extreme_gradients(rng, n, cuda)
    pk, rec, bins_t = thk._channel_records_cuda(bins, pos, gq, ptab, Fh=Fh,
                                                **kw)
    pp, _ = thk._fused_level_plain(bins, pos, gq, ptab, **kw)
    want = thk._channel_records_plain(pp, gq, K=kw["K"], d=d)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    assert torch.equal(rec, want)
    if Fh == F:
        assert bins_t is None
    else:
        assert bins_t.shape == (F - Fh, thk.onehot_rows(n))
        assert bins_t.dtype == bins.dtype
        assert torch.equal(bins_t[:, :n], bins[:, Fh:].t())


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


def _fused_level_checks(bins, pos, gq, ptab, kw):
    """Kernel A twice and its plain version: pos and int64 hist bitwise."""
    pk, hk = thk._fused_level_cuda(bins, pos, gq, ptab, **kw)
    pk2, hk2 = thk._fused_level_cuda(bins, pos, gq, ptab,
                                     bins_t=thk.feature_major(bins), **kw)
    pp, hp = thk._fused_level_plain(bins, pos, gq, ptab, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(hk, hp)
    assert torch.equal(pk2, pk) and torch.equal(hk2, hk)
    return hk


@pytest.mark.parametrize("n,F,B", [(5000, 7, 64), (3001, 5, 256)])
def test_level_kernel_one_bin_k1(cuda, n, F, B):
    """Every row in one bin of every feature at K = 1."""
    rng = np.random.RandomState(n)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, 0, cuda)
    bins = torch.full_like(bins, B // 2)
    hk = _fused_level_checks(bins, pos, gq, ptab, kw)
    assert int(hk[:, 0, B // 2].ne(0).sum()) == F


@pytest.mark.parametrize("n,F,B,d", [
    (70_001, 6, 256, 6),   # K = 64: slices of 22, 22, 20 nodes; ragged
    (70_001, 4, 254, 7),   # K = 128: six slices, the last one shorter
    (130_003, 3, 64, 6),   # uint8, K = 64, ragged
])
def test_level_kernel_node_slices_ragged_chunks(cuda, n, F, B, d):
    rng = np.random.RandomState(n + d)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, d, cuda)
    _fused_level_checks(bins, pos, gq, ptab, kw)


@pytest.mark.parametrize("sign", [1, -1])
def test_level_kernel_halves_exact_past_the_row_cap(cuda, sign):
    """200k rows in one cell of every feature with |q| at the quantiser's
    extreme, at K = 128 and B = 254 with 100 features: six node slices x
    100 feature groups fill the grid with one row chunk each, so the
    halves' 2^16-row cap splits the rows and their sums reach their
    widest."""
    n, F, B, d = 200_003, 100, 254, 7
    K = 1 << d
    bins = torch.full((n, F), 3, dtype=torch.uint8, device=cuda)
    pos = torch.full((n, 1), K - 1 + 5, dtype=torch.int32, device=cuda)
    ptab = torch.zeros((1, 4), dtype=torch.float32, device=cuda)
    qv = (1 << 30) - 1 if sign > 0 else -(1 << 30)
    gq = thk.QuantizedGradients(
        q=torch.full((n, 2), qv, dtype=torch.int32, device=cuda),
        exp=torch.zeros(2, dtype=torch.int32, device=cuda))
    hk = _fused_level_checks(bins, pos, gq, ptab, dict(K=K, Kp=0, B=B, d=d))
    assert int(hk[0, 5, 3]) == n * qv and int(hk[F - 1, K + 5, 3]) == n * qv


def test_level_kernel_device_memory_path(cuda):
    """B = 20000: one node's [2, B] int64 tile (320 KB) exceeds shared
    memory, so the kernel adds into hist directly."""
    rng = np.random.RandomState(11)
    bins, pos, gq, ptab, kw = _level_case(rng, 3000, 3, 20000, 1, cuda)
    _fused_level_checks(bins, pos, gq, ptab, kw)


@pytest.mark.parametrize("n,F,B,d", [(1000, 7, 16, 0), (70_001, 6, 256, 5)])
def test_level_route_launch_records_match_plain(cuda, n, F, B, d):
    rng = np.random.RandomState(n + d + 2)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, d, cuda)
    pk, loc = thk._level_records_cuda(bins, pos, gq, ptab, **kw)
    pp, _ = thk._fused_level_plain(bins, pos, gq, ptab, **kw)
    want = thk._level_records_plain(pp, K=kw["K"], d=d)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(loc, want)


def _permuted(left, right, rng):
    """The same trees with node ids permuted (root kept at 0), as JSON
    models number their nodes: ``(left, right, perm)``, ``perm[new] =
    old``."""
    T, N = left.shape
    perm = np.concatenate([[0], 1 + rng.permutation(N - 1)])
    inv = np.argsort(perm)
    relabel = lambda c: np.where(c >= 0, inv[np.maximum(c, 0)], -1)  # noqa: E731
    return relabel(left[:, perm]), relabel(right[:, perm]), perm


@pytest.mark.parametrize("T,depth,G,n,F,heap", [
    (500, 6, 1, 3000, 50, True),    # ~42 chunks of 12 trees, X staged
    (37, 6, 1, 2001, 50, False),    # a tail of single walks, non-heap
    (23, 5, 3, 1500, 20, True),     # three groups, tree weights, staged
    (9, 4, 3, 777, 8, False),       # three groups, X read directly
    (5, 11, 1, 500, 30, True),      # 4095 nodes: walked from device memory
])
def test_walk_kernel_chunks_groups_and_layouts(cuda, T, depth, G, n, F, heap):
    rng = np.random.RandomState(T + depth + n)
    N = (1 << (depth + 1)) - 1
    internal = (1 << depth) - 1
    idx = np.arange(N)
    left = np.tile(np.where(idx < internal, 2 * idx + 1, -1), (T, 1))
    right = np.tile(np.where(idx < internal, 2 * idx + 2, -1), (T, 1))
    left[:, 2] = right[:, 2] = -1   # a leaf mid-tree
    left[:, 5] = right[:, 5] = -1
    feature = rng.randint(0, F, size=(T, N))
    cond = rng.randn(T, N).astype(np.float32)
    dl = rng.rand(T, N) < 0.5
    if not heap:
        left, right, perm = _permuted(left, right, rng)
        feature, cond, dl = (np.take_along_axis(a, np.tile(perm, (T, 1)), 1)
                             for a in (feature, cond, dl))
    forest = tpred.forest_from_numpy(left, right, feature, cond, dl,
                                     rng.randint(0, G, size=T), depth, G,
                                     device=cuda, heap_layout=heap)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    X = torch.as_tensor(X, device=cuda)
    base = torch.as_tensor(rng.randn(n, G).astype(np.float32), device=cuda)
    tw = torch.as_tensor(rng.uniform(0.5, 2.0, T).astype(np.float32),
                         device=cuda)
    got = tpred._predict_margin_cuda(forest, X, base, tw)
    want = tpred._predict_margin_plain(forest, X, base, tw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_walk_kernel_seven_groups_of_a_multiclass_model(cuda):
    """Kernel B at G = 7 on a 10-round 7-class model's own forest (its
    interleaved ``tree_info``; the device-grown heap stack and the saved
    model's) against the plain walk, with unit and random tree weights."""
    import xgboost_tpu_torch as xgbt

    rng = np.random.RandomState(70)
    n, F, K = 6000, 12, 7
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = np.argmax(np.nan_to_num(X) @ rng.randn(F, K)
                  + rng.gumbel(size=(n, K)), 1).astype(np.float32)
    bst = xgbt.train({"objective": "multi:softprob", "num_class": K,
                      "max_depth": 6, "eta": 0.3},
                     xgbt.DMatrix(X, y, device=cuda), 10, verbose_eval=False)
    Xt = torch.as_tensor(X, device=cuda)
    base = torch.as_tensor(rng.randn(n, K).astype(np.float32), device=cuda)
    heap = bst._gbm.model.stacked()
    saved = xgbt.Booster(model_file=bst.save_raw(),
                         device=cuda)._gbm.model.stacked()
    for forest in (heap, saved):
        assert forest.n_groups == K and forest.num_trees == 10 * K
        assert forest.tree_group.tolist() == list(range(K)) * 10
        for tw in (forest.unit_weights, torch.as_tensor(
                rng.uniform(0.5, 2.0, 10 * K).astype(np.float32),
                device=cuda)):
            got = tpred._predict_margin_cuda(forest, Xt, base, tw)
            want = tpred._predict_margin_plain(forest, Xt, base, tw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,F,B,Fh,d", [
    (1000, 7, 16, 7, 1),        # K = 2, full hoist, uint8
    (5000, 50, 64, 50, 5),      # the main path's width at K = 32
    (4001, 12, 256, 5, 5),      # int16, partial hoist, the [Kp, 261] table
    (3001, 6, 256, 6, 3),       # int16, full hoist
    (70_001, 6, 256, 2, 6),     # K = 64, node slices in kernel A
])
def test_level_kernels_categorical_table_match_plain_bitwise(cuda, n, F, B,
                                                             Fh, d):
    rng = np.random.RandomState(n + d + B + 3)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, d, cuda,
                                          categorical=True)
    assert ptab.shape[1] == 5 + B
    onehot = thk._build_onehot_cuda(bins, B=B, Fh=Fh)
    pa, ha = thk._fused_level_cuda(bins, pos, gq, ptab, **kw)
    pd, hd = thk._hoisted_level_cuda(bins, onehot, pos, gq, ptab, **kw)
    pp, hp = thk._fused_level_plain(bins, pos, gq, ptab, **kw)
    pr, loc = thk._level_records_cuda(bins, pos, gq, ptab, **kw)
    pc, rec, _ = thk._channel_records_cuda(bins, pos, gq, ptab, Fh=Fh, **kw)
    torch.cuda.synchronize()
    # the categorical nodes route some rows differently from the same
    # table read as numerical
    pn = thk._fused_level_plain(bins, pos, gq, ptab[:, :4].contiguous(),
                                **kw)[0]
    assert kw["Kp"] == 0 or not torch.equal(pp, pn)
    for p_ in (pa, pd, pr, pc):
        assert torch.equal(p_, pp)
    assert torch.equal(ha, hp) and torch.equal(hd, hp)
    assert torch.equal(loc, thk._level_records_plain(pp, K=kw["K"], d=d))
    assert torch.equal(rec, thk._channel_records_plain(pp, gq, K=kw["K"],
                                                       d=d))


def test_level_kernels_categorical_table_of_another_width_raises(cuda):
    rng = np.random.RandomState(8)
    bins, pos, gq, ptab, kw = _level_case(rng, 500, 5, 16, 2, cuda,
                                          categorical=True)
    onehot = thk._build_onehot_cuda(bins, B=16, Fh=5)
    for bad in (ptab[:, :5], ptab[:, :4 + 16]):
        with pytest.raises(ValueError, match="ptab"):
            thk._fused_level_cuda(bins, pos, gq, bad.contiguous(), **kw)
        with pytest.raises(ValueError, match="ptab"):
            thk._hoisted_level_cuda(bins, onehot, pos, gq, bad.contiguous(),
                                    **kw)


def test_walk_kernel_past_2_31_elements(cuda):
    """43M rows x 50 features, just over 2^31 elements (8.6 GB of X): the
    wrapper walks two row chunks; rows at both sides of the chunk boundary,
    of the 2^31st element and at the end equal the plain walk's."""
    F, T, depth = 50, 10, 6
    n = (1 << 31) // F + 1
    assert n * F > 1 << 31
    chunks = tpred.walk_row_chunks(n, F)
    assert len(chunks) == 2
    rng = np.random.RandomState(31)
    N = (1 << (depth + 1)) - 1
    internal = (1 << depth) - 1
    idx = np.arange(N)
    left = np.tile(np.where(idx < internal, 2 * idx + 1, -1), (T, 1))
    right = np.tile(np.where(idx < internal, 2 * idx + 2, -1), (T, 1))
    forest = tpred.forest_from_numpy(
        left, right, rng.randint(0, F, size=(T, N)),
        rng.randn(T, N).astype(np.float32), rng.rand(T, N) < 0.5,
        np.zeros(T), depth, 1, device=cuda, heap_layout=True)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(31)
    X = torch.randn((n, F), generator=gen, device=cuda)
    X.view(-1)[::19] = float("nan")
    base = torch.zeros((n, 1), device=cuda)
    before = tpred.predict_margin.launches
    got = tpred.predict_margin(forest, X, base)
    assert tpred.predict_margin.launches == before + 2
    edge = chunks[0][1]
    at_2_31 = (1 << 31) // F
    tw = torch.ones(T, device=cuda)
    for lo in (0, edge - 3000, at_2_31 - 3000, n - 3000):
        rows = slice(lo, lo + 6000) if lo + 6000 <= n else slice(lo, n)
        want = tpred._predict_margin_plain(forest, X[rows], base[rows], tw)
        torch.testing.assert_close(got[rows], want, rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(got).all())


_OBJECTIVES = [
    ("reg:squarederror", {}), ("reg:squaredlogerror", {}),
    ("reg:pseudohubererror", {}), ("reg:pseudohubererror",
                                   {"huber_slope": 1.7}),
    ("reg:logistic", {}), ("binary:logistic", {"scale_pos_weight": 3.0}),
    ("binary:hinge", {}), ("count:poisson", {}), ("reg:gamma", {}),
    ("reg:tweedie", {"tweedie_variance_power": 1.3}),
    ("multi:softprob", {"num_class": 7}),
    ("survival:aft", {"aft_loss_distribution": "normal",
                      "aft_loss_distribution_scale": 1.3}),
    ("survival:aft", {"aft_loss_distribution": "logistic"}),
    ("survival:aft", {"aft_loss_distribution": "extreme",
                      "aft_loss_distribution_scale": 0.7}),
    ("survival:cox", {}),
] + [
    # ranking: each scheme on both gradient paths (``_path``: the group
    # sizes that select it), with and without per-group weights
    (name, {"_path": path, "_group_weights": gw,
            "lambdarank_num_pair_per_sample": 2})
    for name in ("rank:pairwise", "rank:ndcg", "rank:map")
    for path in ("all_pairs", "sampled") for gw in (False, True)
] + [
    # 3 pairs per row: the sampled weights divide by 6, not a power of two
    (name, {"_path": "sampled", "_group_weights": False,
            "lambdarank_num_pair_per_sample": 3})
    for name in ("rank:pairwise", "rank:ndcg", "rank:map")
]


@pytest.mark.parametrize("name,params", _OBJECTIVES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(_OBJECTIVES)])
def test_objective_gradients_same_bits_on_card_and_cpu(cuda, name, params):
    """Every objective's gradients, hessians and transforms on the card
    equal the CPU's bit for bit (float64 transcendentals and square roots
    rounded once, IEEE quotients), and so do their quantised values (exact
    power-of-two scales): the trees then grow the same on either. 200k
    rows of margins, labels and censoring intervals. The ranking cases run
    on query groups of 8-32 rows (the all-pairs path) or 60-180 (the
    sampled path, whose opponent ends are summed in a fixed order) with
    graded labels 0-4, margins rounded to one decimal (ties), and per-row
    or per-group weights."""
    from xgboost_tpu_torch.objective import create_objective
    from xgboost_tpu_torch.params import LearnerParam

    params = dict(params)
    path = params.pop("_path", None)
    group_weights = params.pop("_group_weights", False)
    rng = np.random.RandomState(9)
    n = 200_000
    if path is not None:
        return _ranking_same_bits(cuda, name, params, path, group_weights,
                                  rng, n)
    K = params.get("num_class", 1)
    m = (rng.randn(n, K) * 2.0).astype(np.float32)
    m = m[:, 0] if K == 1 else m
    t = rng.gamma(2.0, 10.0, n).astype(np.float32)
    u = rng.rand(n)
    label = {
        "multi:softprob": rng.randint(0, K, n),
        "survival:cox": np.where(u < 0.3, -t, t),
        "reg:logistic": u,
        "binary:logistic": (u < 0.4), "binary:hinge": (u < 0.4),
        "reg:pseudohubererror": rng.standard_t(2.0, n),
        "reg:squaredlogerror": np.expm1(rng.randn(n)),
    }.get(name, t / 10.0).astype(np.float32)
    lower = np.where(u < 0.1, 0.0, np.where(u < 0.3, 0.6 * t, t))
    upper = np.where(u < 0.3, 1.4 * t, np.where(u < 0.6, np.inf, t))
    obj = create_objective(name, LearnerParam(objective=name, **params))
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        def T(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        g, h = obj.get_gradient(T(m), T(label), T(w), 0, label_lower=T(lower),
                                label_upper=T(upper))
        gq = thk.quantize_gradients(g if g.dim() == 1 else g[:, 0],
                                    h if h.dim() == 1 else h[:, 0])
        out.append([v.cpu() for v in (g, h, obj.pred_transform(T(m)),
                                      obj.eval_transform(T(m)), gq.q,
                                      gq.exp)])
    for what, a, b in zip(("grad", "hess", "pred", "eval", "q", "exp"),
                          *out):
        bad = int((a != b).sum()) - int((a.isnan() & b.isnan()).sum())
        assert bad == 0, f"{name} {what}: {bad} values differ"


def _ranking_same_bits(cuda, name, params, path, group_weights, rng, n):
    from xgboost_tpu_torch.data.dmatrix import QueryGroups
    from xgboost_tpu_torch.objective import create_objective
    from xgboost_tpu_torch.objective import ranking as trank
    from xgboost_tpu_torch.params import LearnerParam

    lo, hi = (8, 33) if path == "all_pairs" else (60, 181)
    sizes = rng.randint(lo, hi, n // lo)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), n)]
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    rows = int(ptr[-1])
    G, S = len(sizes), int(sizes.max())
    assert (G * S * S > trank._ALL_PAIRS_BUDGET) == (path == "sampled")
    m = np.round(rng.randn(rows) * 2.0, 1).astype(np.float32)
    label = rng.randint(0, 5, rows).astype(np.float32)
    w = rng.uniform(0.5, 2.0, G if group_weights else rows).astype(
        np.float32)
    obj = create_objective(name, LearnerParam(objective=name, **params))
    out = []
    for dev in (cuda, torch.device("cpu")):
        def T(a):
            return torch.as_tensor(a, device=dev)
        g, h = obj.get_gradient(T(m), T(label), T(w), 3,
                                groups=QueryGroups(ptr, dev))
        gq = thk.quantize_gradients(g, h)
        out.append([v.cpu() for v in (g, h, gq.q, gq.exp)])
    for what, a, b in zip(("grad", "hess", "q", "exp"), *out):
        bad = int((a != b).sum())
        assert bad == 0, f"{name} {path} {what}: {bad} values differ"


@pytest.mark.parametrize("n,F,B,K", [(70_001, 50, 256, 2),
                                     (70_001, 50, 256, 16),
                                     (5000, 7, 64, 16), (1, 3, 16, 2)])
def test_level_kernel_child_slots_at_d0_match_plain(cuda, n, F, B, K):
    """The lossguide grower's child histograms: kernel A at ``d = 0``,
    ``Kp = 0`` (no routing) with each row's child slot in ``[-1, K)`` as
    its position (-1: no child), bitwise equal to its plain version."""
    rng = np.random.RandomState(n + K)
    bins, _, gq, ptab, _ = _level_case(rng, n, F, B, 0, cuda)
    seg = torch.as_tensor(rng.randint(-1, K, size=(n, 1)).astype(np.int32),
                          device=cuda)
    _fused_level_checks(bins, seg, gq, ptab[:1, :4],
                        dict(K=K, Kp=0, B=B, d=0))


@pytest.mark.parametrize("max_leaves,kw", [
    (31, dict(max_depth=0, subsample=0.8, colsample_bynode=0.8,
              monotone=(1, 0, -1))),
    (100, dict(max_depth=0, colsample_bylevel=0.7,
               interaction=((0, 1, 2), (3, 4, 5, 6)))),
])
def test_lossguide_tree_same_on_card_and_cpu(cuda, max_leaves, kw):
    """A lossguide tree (kernel A on the card, the plain version on the
    CPU) and its finalize pass: every array equal bitwise."""
    from xgboost_tpu_torch import threefry
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree import grow_lossguide as tlg

    rng = np.random.RandomState(max_leaves)
    n, F, B = 20_000, 7, 64
    bins = rng.randint(0, B + 1, size=(n, F)).astype(np.uint8)
    cuts = np.sort(rng.randn(F, B).astype(np.float32), axis=1)
    g = rng.randn(n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    cfg = tgrow.GrowParams(**kw)
    out = []
    for dev in (cuda, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        tree = tlg.grow_tree_lossguide(
            t(bins), t(g), t(h), t(cuts), cfg, max_leaves,
            key=threefry.prng_key(3),
            bins_t=thk.feature_major(t(bins)) if dev.type == "cuda" else None)
        fin = tlg.finalize_alloc(tree, 0.1, 0.2)
        out.append([x.cpu() for x in (*tree, *fin)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _shap_model(case):
    """A CPU-trained model's JSON, its rows and feature types (the card
    SHAP cases)."""
    import xgboost_tpu_torch as xgbt

    rng = np.random.RandomState(7)
    n, F = 4000, 8
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    types = None
    params = {"objective": "binary:logistic", "max_depth": 6, "max_bin": 64}
    y = (np.nan_to_num(X) @ rng.randn(F) > 0).astype(np.float32)
    if case == "categorical":
        X[:, 2] = rng.randint(0, 3, n)
        X[:, 5] = rng.randint(0, 20, n)
        types = ["q", "q", "c", "q", "q", "c", "q", "q"]
    elif case == "multiclass":
        params.update(objective="multi:softprob", num_class=3)
        y = np.argmax(np.nan_to_num(X) @ rng.randn(F, 3), 1)
    elif case == "lossguide":
        params.update(grow_policy="lossguide", max_leaves=63, max_depth=0)
    bst = xgbt.train(params, xgbt.DMatrix(X, y, feature_types=types,
                                          device="cpu"), 3, verbose_eval=False)
    return bst.save_raw(), X, types


@pytest.mark.parametrize("case,table_max_d", [
    ("depth6", 12), ("categorical", 12), ("multiclass", 12),
    ("lossguide", 12), ("lossguide", 4)])
def test_shap_same_on_card_and_cpu(cuda, case, table_max_d, monkeypatch):
    """Contributions, Saabas and interactions of one model on the card and
    on the CPU within 1e-9 (float64 sums in other orders); at
    ``_TABLE_MAX_D`` 4 the lossguide tree's longer paths take the row DP."""
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch import interpret

    monkeypatch.setattr(interpret, "_TABLE_MAX_D", table_max_d)
    raw, X, types = _shap_model(case)
    out = []
    for dev in ("cuda", "cpu"):
        bst = xgbt.Booster(model_file=raw, device=dev)
        d = xgbt.DMatrix(X, feature_types=types, device=dev)
        out.append([bst.predict(d, pred_contribs=True),
                    bst.predict(d, pred_contribs=True, approx_contribs=True),
                    bst.predict(xgbt.DMatrix(X[:1000], feature_types=types,
                                             device=dev),
                                pred_interactions=True)])
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.mark.parametrize("params", [
    {"feature_selector": s} for s in ("cyclic", "shuffle", "random",
                                      "greedy", "thrifty")] + [
    {"updater": "shotgun"},
    {"objective": "multi:softprob", "num_class": 3,
     "feature_selector": "random"}])
def test_gblinear_same_on_card_and_cpu(cuda, params):
    """The linear booster's weights after 5 rounds on the card and on the
    CPU within rtol 1e-6 (each sum in float64, rounded to float32)."""
    import xgboost_tpu_torch as xgbt

    rng = np.random.RandomState(3)
    n, F = 50_000, 20
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = (np.nan_to_num(X) @ rng.randn(F)).astype(np.float32)
    if "num_class" in params:
        y = (y > 0).astype(np.float32) + (y > 1)
    p = {"booster": "gblinear", **params}
    w = [xgbt.train(p, xgbt.DMatrix(X, y, device=dev), 5,
                    verbose_eval=False)._gbm.host_weights()
         for dev in ("cuda", "cpu")]
    np.testing.assert_allclose(w[0], w[1], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the other tree methods: exact widths, the local histmaker, refresh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,F,B,d", [
    (200_001, 3, 16_001, 0),  # exact's widest: one node's [2, B] tile
    (200_001, 3, 16_001, 5),  # exceeds shared memory (the global branch)
    (70_001, 4, 7_175, 5),    # Covertype's exact width: node slices
])
def test_level_kernel_matches_plain_at_exact_widths(cuda, n, F, B, d):
    rng = np.random.RandomState(n + B + d)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, d, cuda)
    _fused_level_checks(bins, pos, gq, ptab, kw)


@pytest.mark.parametrize("n,F,B,Fh,d", [
    (20_001, 6, 7_175, 2, 0),  # a partial hoist at exact's width
    (20_001, 6, 7_175, 2, 5),
])
def test_hoisted_kernel_partial_hoist_at_wide_bins(cuda, n, F, B, Fh, d):
    """Kernel C and kernel D at B in the thousands (int16 bins), the
    unhoisted features built per level: equal to their plain versions and
    to kernel A."""
    rng = np.random.RandomState(n + d)
    bins, pos, gq, ptab, kw = _level_case(rng, n, F, B, d, cuda)
    onehot = thk._build_onehot_cuda(bins, B=B, Fh=Fh)
    assert torch.equal(onehot, thk._build_onehot_plain(bins, B=B, Fh=Fh))
    pk, hk = thk._hoisted_level_cuda(bins, onehot, pos, gq, ptab, **kw)
    pp, hp = thk._hoisted_level_plain(bins, onehot, pos, gq, ptab, **kw)
    pa, ha = thk._fused_level_cuda(bins, pos, gq, ptab, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(pk, pa)
    assert torch.equal(hk, hp) and torch.equal(hk, ha)


@pytest.mark.parametrize("kw", [
    dict(max_depth=6),
    dict(max_depth=4, subsample=0.8, colsample_bynode=0.7,
         monotone=(1, 0, -1)),
])
def test_local_tree_same_on_card_and_cpu(cuda, kw):
    """A ``grow_local_histmaker`` tree (per-node sketches on the device,
    kernel A at d = 0 on the card, the plain version on the CPU) on
    continuous gradients and hessians: every array equal bitwise."""
    from xgboost_tpu_torch import threefry
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree import grow_local as tgl

    rng = np.random.RandomState(17)
    n, F = 30_000, 7
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    g = rng.randn(n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        tree = tgl.grow_tree_local(t(X), t(g), t(h), tgrow.GrowParams(**kw),
                                   256, 0.3, 0.5, key=threefry.prng_key(5))
        out.append([x.cpu() for x in tree])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_bin", [37, 100, 1000])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuts_same_on_card_and_cpu(cuda, max_bin, weighted):
    """``compute_cuts`` at a ``max_bin`` that is not a power of two, with
    unit weights (the prefix sum on the card) and hessian-like weights (on
    the host): the levels' explicit reciprocal rounds alike on both, so
    the cuts are equal bit for bit."""
    from xgboost_tpu_torch.data.quantile import compute_cuts

    rng = np.random.RandomState(max_bin)
    n, F = 100_037, 8
    X = rng.randn(n, F).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 20)
    X[rng.rand(n, F) < 0.05] = np.nan
    p = 1.0 / (1.0 + np.exp(-rng.randn(n)))
    w = (p * (1.0 - p)).astype(np.float32) if weighted else None
    got = [compute_cuts(torch.as_tensor(X, device=dev), max_bin,
                        None if w is None else torch.as_tensor(w, device=dev))
           for dev in (cuda, "cpu")]
    np.testing.assert_array_equal(got[0].values, got[1].values)
    np.testing.assert_array_equal(got[0].min_vals, got[1].min_vals)


@pytest.mark.parametrize("max_bin", [37, 100])
def test_local_tree_same_on_card_and_cpu_off_power_of_two(cuda, max_bin):
    """A local histmaker tree at a ``max_bin`` that is not a power of two on
    continuous hessians: the per-node targets (reciprocal levels, fused
    multiply-add) and node totals (row order) round alike on the card and
    on the CPU, so every array is equal bitwise."""
    from xgboost_tpu_torch import threefry
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree import grow_local as tgl

    rng = np.random.RandomState(19)
    n, F = 30_011, 7
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    g = rng.randn(n).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-rng.randn(n)))
    h = (p * (1.0 - p)).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        tree = tgl.grow_tree_local(t(X), t(g), t(h),
                                   tgrow.GrowParams(max_depth=6), max_bin,
                                   0.3, 0.0, key=threefry.prng_key(5))
        out.append([x.cpu() for x in tree])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("F,n,K", [
    (1, 1_000_003, 1),   # one feature: still one thread a segment
    (50, 200_003, 1),    # the root of a 50-feature level
    (7, 300_007, 64),    # a depth-6 level, a tail of left-out rows
])
def test_local_node_totals_in_row_order_on_card(cuda, F, n, K):
    """``grow_local._segment_totals`` on weights over six orders of
    magnitude: every (feature, node) total on the card equals the CPU's
    and numpy's left-to-right float32 sum bit for bit (a tree reduction
    or an atomic scatter rounds otherwise)."""
    from xgboost_tpu_torch.tree.grow_local import _segment_totals

    rng = np.random.RandomState(n + K)
    w = (rng.rand(F, n) ** 3 * 10.0 ** rng.randint(-3, 3, (F, n))
         ).astype(np.float32)
    bounds = np.sort(rng.randint(0, n, (F, K + 1)), axis=1)
    bounds[:, 0] = 0
    want = np.zeros((F, K), np.float32)
    for f in range(F):
        for k in range(K):
            seg = w[f, bounds[f, k]:bounds[f, k + 1]]
            if seg.size:
                want[f, k] = np.add.accumulate(seg)[-1]
    got = []
    for dev in (cuda, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        got.append(_segment_totals(t(w), t(bounds[:, :-1]),
                                   t(bounds[:, 1:])).cpu().numpy())
    np.testing.assert_array_equal(got[1], want)
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("params", [
    {"tree_method": "approx", "max_bin": 64},
    {"tree_method": "exact"},
    {"updater": "grow_local_histmaker", "max_bin": 64},
])
def test_method_trees_same_on_card_and_cpu(cuda, params):
    """3 rounds of ``approx`` (a matrix sketched per round), ``exact``
    (int16 bins) and the local histmaker on the card and on the CPU: the
    same model bytes; then refreshing that model (``process_type="update"``
    on other rows) gives the same bytes on both."""
    import xgboost_tpu_torch as xgbt

    rng = np.random.RandomState(23)
    n, F = 20_000, 6
    X = rng.randn(n, F).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 300)  # ~2,000 distinct values
    X[rng.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(F) / 50 + rng.randn(n)) > 0
         ).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 5, **params}
    raw, refreshed = [], []
    for dev in (cuda, "cpu"):
        d = xgbt.DMatrix(X[:15_000], y[:15_000], device=dev)
        bst = xgbt.train(p, d, 3, verbose_eval=False)
        raw.append(bst.save_raw())
        d2 = xgbt.DMatrix(X[15_000:], y[15_000:], device=dev)
        upd = xgbt.train({**p, "process_type": "update"}, d2, 3,
                         xgb_model=bst, verbose_eval=False)
        refreshed.append(upd.save_raw())
    assert raw[0] == raw[1]
    assert refreshed[0] == refreshed[1]


def _paged_and_stream(dev, tmp_path, max_bin, n=150_000, F=12, pages=40_000):
    """An external-memory matrix (pages of ``pages`` rows, the last
    shorter) and a streaming matrix of the same 3 batches on ``dev``."""
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.data.iterator import StreamingQuantileDMatrix

    rng = np.random.RandomState(29)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(F) + rng.randn(n)) > 0).astype(
        np.float32)

    class It(xgbt.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self, input_data):
            if self.i >= 3:
                return 0
            sl = slice(self.i * n // 3, (self.i + 1) * n // 3)
            input_data(data=X[sl], label=y[sl])
            self.i += 1
            return 1
    paged = xgbt.ExternalMemoryQuantileDMatrix(
        It(), cache_prefix=str(tmp_path / f"c{max_bin}"), max_bin=max_bin,
        page_rows=pages, device=dev)
    return paged, StreamingQuantileDMatrix(It(), max_bin=max_bin, device=dev)


@pytest.mark.parametrize("max_bin", [64, 256])
def test_paged_levels_equal_in_memory_levels(cuda, tmp_path, max_bin):
    """At every level of a depth-6 tree, kernel A on each page (unpacked on
    the card) equals its plain version bit for bit, and the pages' int64
    histograms sum to kernel A's histogram of the whole matrix; then the
    paged trees (3 rounds) equal the streaming matrix's on the card and the
    paged trees on the CPU."""
    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.tree import grow as tgrow
    from xgboost_tpu_torch.tree.grow_fused import (_init_state,
                                                   _level_update)

    paged, stream = _paged_and_stream(cuda, tmp_path, max_bin)
    pg = paged._paged
    whole = stream.get_binned(max_bin)
    B = whole.cuts.max_bin
    g = torch.as_tensor(np.random.RandomState(3).randn(pg.n_rows)
                        .astype(np.float32), device=cuda)
    gq = thk.quantize_gradients(g, torch.full_like(g, 0.25))
    cfg = tgrow.GrowParams(max_depth=6)
    st = _init_state(cfg, gq.totals(), B, pg.n_features)
    pos = [torch.zeros((pg.rows_of(k), 1), dtype=torch.int32, device=cuda)
           for k in range(pg.n_pages)]
    pos_all = torch.zeros((pg.n_rows, 1), dtype=torch.int32, device=cuda)
    for d in range(6):
        K = 1 << d
        hist = 0
        for k in range(pg.n_pages):
            lo = k * pg.page_rows
            bins = pg.device_page(k, cuda)
            assert torch.equal(bins, whole.bins[lo:lo + pg.rows_of(k)])
            sub = thk.QuantizedGradients(q=gq.q[lo:lo + pg.rows_of(k)],
                                         exp=gq.exp)
            kw = dict(K=K, Kp=K >> 1, B=B, d=d)
            p1, h1 = thk._fused_level_cuda(bins, pos[k], sub, st.ptab, **kw)
            p2, h2 = thk._fused_level_plain(bins, pos[k], sub, st.ptab, **kw)
            assert torch.equal(p1, p2) and torch.equal(h1, h2)
            pos[k], hist = p1, hist + h1
        pos_all, want = thk._fused_level_cuda(whole.bins, pos_all, gq,
                                              st.ptab, K=K, Kp=K >> 1, B=B,
                                              d=d)
        assert torch.equal(hist, want)
        assert torch.equal(torch.cat(pos), pos_all)
        histC = gq.dequantize(hist, thk.level_lanes(K, cuda))
        st = _level_update(st, histC, whole.cut_values, cfg, d)
    p = {"objective": "binary:logistic", "max_depth": 6, "max_bin": max_bin}
    raw = xgbt.train(p, paged, 3, verbose_eval=False).save_raw()
    assert raw == xgbt.train(p, stream, 3, verbose_eval=False).save_raw()
    (tmp_path / "cpu").mkdir()
    cpu_paged, _ = _paged_and_stream("cpu", tmp_path / "cpu", max_bin)
    assert raw == xgbt.train(p, cpu_paged, 3, verbose_eval=False).save_raw()


def test_csr_inplace_predict_equals_dense_on_card(cuda):
    """CSR ``inplace_predict`` (row blocks of 65,536 made dense on the host,
    kernel B on each) equals the dense ``inplace_predict`` of the same rows
    bit for bit, and a CSR matrix trained on the card grows the dense
    matrix's trees without making its dense ``data``."""
    import scipy.sparse as sp

    import xgboost_tpu_torch as xgbt

    rng = np.random.RandomState(31)
    m = sp.random(140_000, 30, density=0.2, format="csr", random_state=rng,
                  data_rvs=lambda k: rng.randn(k).astype(np.float32))
    dense = np.full(m.shape, np.nan, np.float32)
    c = m.tocoo()
    dense[c.row, c.col] = c.data
    y = (np.nan_to_num(dense) @ rng.randn(30) > 0).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 6}
    ds = xgbt.DMatrix(m, y, device=cuda)
    bst = xgbt.train(p, ds, 4, verbose_eval=False)
    assert ds._data is None
    dd = xgbt.DMatrix(dense, y, device=cuda)
    assert bst.save_raw() == xgbt.train(p, dd, 4,
                                        verbose_eval=False).save_raw()
    np.testing.assert_array_equal(bst.inplace_predict(m),
                                  bst.inplace_predict(dense))
    np.testing.assert_array_equal(bst.predict(ds), bst.predict(dd))
    assert ds._data is None


def test_distributed_gloo_on_the_card_equals_the_cpu(cuda, tmp_path):
    """Two ranks over gloo on the card (both on one card: gloo stages the
    int64 histograms through the host) and two ranks on the CPU, 3 rounds
    at 64k rows in ragged shards on shared cuts: the same model bytes on
    all four ranks and the same trees, depthwise and lossguide."""
    from test_torch_distributed import spawn

    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card = spawn(tmp_path / "card", 2, "cuda", timeout=600, mode="card")
    cpu = spawn(tmp_path / "cpu", 2, "cpu", timeout=600, mode="card")
    raws = [r["raw"] for r in card + cpu]
    assert raws.count(raws[0]) == 4
    for a, b in zip(card[0]["trees"], cpu[0]["trees"]):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], f)
    raws = [r["lossguide_raw"] for r in card + cpu]
    assert raws.count(raws[0]) == 4


def test_resume_on_the_card_equals_straight_and_cpu(cuda, tmp_path):
    """A 64k-row run on the card (depth 6, max_bin 256), SIGKILLed after
    round 3's ``after_iteration`` and run again, gives the uninterrupted
    card run's bytes, and its trees are the CPU's (the workers are
    ``tests/test_torch_crash_resume.py``'s)."""
    import json
    import signal

    import xgboost_tpu_torch as xgbt
    from test_torch_crash_resume import (CARD_PARAMS, CARD_SHAPE, KILL_AFTER,
                                         ROUNDS, _run, _wait, data)
    from xgboost_tpu_torch.resilience import checkpoint

    ck = tmp_path / "ck"
    (rc, out), = _wait([_run(["single", "card", ck, tmp_path / "r.bin"],
                             KILL_AFTER)], timeout=600)
    assert rc == -signal.SIGKILL, out[-3000:]
    assert 1 <= checkpoint.load_latest(str(ck))[1] <= KILL_AFTER - 1
    for rc, out in _wait([_run(["single", "card", ck, tmp_path / "r.bin"]),
                          _run(["single", "card", tmp_path / "ck_ref",
                                tmp_path / "s.bin"])], timeout=600):
        assert rc == 0, out[-3000:]
    resumed = (tmp_path / "r.bin").read_bytes()
    assert resumed == (tmp_path / "s.bin").read_bytes()
    X, y = data(*CARD_SHAPE)
    cpu = xgbt.train(CARD_PARAMS, xgbt.DMatrix(X, y, device="cpu"), ROUNDS,
                     verbose_eval=False)

    def trees(raw):
        return json.loads(raw)["learner"]["gradient_booster"]["model"][
            "trees"]

    assert trees(resumed) == trees(cpu.save_raw())


def test_pipeline_on_the_card_equals_depth_0_and_cpu(cuda, monkeypatch):
    """``-k pipeline``: 5 rounds of 64k rows (depth 6, max_bin 64) through
    ``train`` and ``update_many`` at ``XGBTPU_PIPELINE_DEPTH`` 0, 1 and 2
    give one set of bytes, whose trees are the CPU's; each admitted round's
    handle is a ``torch.cuda.Event`` that has completed after the drain."""
    import json

    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch import learner as tlearner
    from test_torch_crash_resume import data

    X, y = data(65_536, 20)
    params = {"objective": "binary:logistic", "max_depth": 6, "max_bin": 64,
              "eta": 0.1, "verbosity": 0}
    probes = []
    real = tlearner.completion_probe

    def probe(t):
        probes.append(real(t))
        return probes[-1]

    monkeypatch.setattr(tlearner, "completion_probe", probe)
    raws = set()
    for depth in "012":
        monkeypatch.setenv("XGBTPU_PIPELINE_DEPTH", depth)
        d = xgbt.DMatrix(X, y, device=cuda)
        raws.add(xgbt.train(params, d, 5, verbose_eval=False).save_raw())
        b = xgbt.Booster(params, [d], device=cuda)
        b.update_many(d, 0, 5, chunk=2)
        b._pipeline.drain()
        raws.add(b.save_raw())
    assert len(raws) == 1
    assert len(probes) == 9
    assert all(isinstance(e, torch.cuda.Event) and e.query() for e in probes)
    cpu = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 5,
                     verbose_eval=False)

    def trees(raw):
        return json.loads(raw)["learner"]["gradient_booster"]["model"][
            "trees"]

    assert trees(raws.pop()) == trees(cpu.save_raw())


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softprob"])
def test_serving_coalesced_dispatch_equals_plain_bitwise(cuda, objective):
    """``-k serving``: a model server on the card answers 64 one-row
    requests queued behind a held dispatch with ONE coalesced dispatch
    (one kernel B launch) whose rows equal kernel B's plain version on CPU
    copies of the same rows, transform included, bit for bit."""
    import threading

    import xgboost_tpu_torch as xgbt
    from xgboost_tpu_torch.serving import ModelServer

    rng = np.random.RandomState(3)
    X = rng.randn(2000, 12).astype(np.float32)
    X[rng.rand(*X.shape) < 0.1] = np.nan
    params = {"objective": objective, "max_depth": 5}
    if objective == "multi:softprob":
        params["num_class"] = 3
        y = rng.randint(0, 3, len(X)).astype(np.float32)
    else:
        y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    cpu = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 8)
    want = cpu.inplace_predict(X[:65])  # the plain version on the CPU
    srv = ModelServer(device=cuda, batch_wait_us=1000)
    try:
        srv.load("m", cpu.save_raw())
        entry = srv.registry.get("m")
        real, entered, go = entry.predict, threading.Event(), threading.Event()
        rows = []

        def held(Xq, **kw):
            rows.append(len(Xq))
            entered.set()
            assert go.wait(60)
            return real(Xq, **kw)

        entry.predict = held
        first = srv.predict_async("m", X[:1])
        assert entered.wait(60)
        futs = [srv.predict_async("m", X[i:i + 1]) for i in range(1, 65)]
        b0 = tpred.predict_margin.launches
        go.set()
        first.result(60)
        got = np.concatenate([f.result(60) for f in futs])
        assert rows == [1, 64]
        # the held dispatch's launch and the coalesced one's
        assert tpred.predict_margin.launches - b0 == 2
        np.testing.assert_array_equal(got, want[1:65])
    finally:
        srv.close()


def _scan_input(shape, seed, dev):
    """float32 normals of ``shape`` [..., B] with the edge values on the
    first rows: all -0.0, a leading -0.0, +inf then -inf (their NaN), a
    mid-row NaN, -inf, subnormals only, subnormals whose sums cross into
    the normal range and back."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    B, tiny = shape[-1], np.finfo(np.float32).tiny
    edge = [np.full(B, -0.0), np.r_[-0.0, rows[1, 1:]],
            np.r_[np.inf, -np.inf, rows[2, 2:]][:B],
            np.r_[rows[3, :B // 2], np.nan, rows[3, B // 2 + 1:]][:B],
            np.r_[-np.inf, rows[4, 1:]], np.full(B, tiny * 0.375),
            np.where(np.arange(B) % 2 == 0, 1.25 * tiny, -1.125 * tiny)]
    for i, e in enumerate(edge[:len(rows)]):
        rows[i] = e
    return torch.as_tensor(x, device=dev)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("shape", [
    *[(2, 1 << d, F, 256) for d in range(6) for F in (50, 136)],
    (4, 32, 50, 256),        # a categorical partition level: 4 lanes
    (2, 8, 50, 64), (2, 4, 54, 7175), (2, 2, 8, 16001),  # other widths
    (7, 1), (9, 2), (33, 257), (65, 33),  # ragged rows and chunks
])
def test_scan_kernel_matches_plain_bitwise(cuda, shape):
    """Kernel S, ``seq_cumsum`` on the card, equals the plain loop on the
    card bit for bit (NaN patterns included) at the main path's level
    shapes ``[2, K, F, B]`` (d = 0-5, F = 50 and 136, B = 256), the
    partition path's 4 lanes, the other widths (B = 64, 7,175, 16,001) and
    ragged rows and chunks, each with the edge rows of ``_scan_input``;
    one launch a call."""
    x = _scan_input(shape, sum(shape), cuda)
    before = tgrow.seq_cumsum.launches
    got = tgrow.seq_cumsum(x)
    assert tgrow.seq_cumsum.launches == before + 1
    want = tgrow._seq_cumsum_plain(x)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    flat = got.reshape(-1, shape[-1])
    assert flat[0].view(torch.int32).eq(0).all()  # -0.0 rows sum to +0.0
    if flat.shape[0] > 5:
        assert (flat[5] != 0.0).all()  # subnormals kept, not flushed


def test_scan_kernel_wrapper_raises(cuda):
    """What kernel S does not take raises: float64, a non-contiguous view,
    an output of another shape, type, device or layout; an empty input
    launches nothing."""
    x = torch.randn(2, 3, 5, 16, device=cuda)
    with pytest.raises(ValueError, match="seq_cumsum"):
        tgrow.seq_cumsum(x.double())
    with pytest.raises(ValueError, match="seq_cumsum"):
        tgrow.seq_cumsum(x.transpose(-1, -2))
    with pytest.raises(ValueError, match="seq_cumsum"):
        tgrow.seq_cumsum(x[..., ::2])
    for out in (torch.empty(2, 3, 5, 15, device=cuda),
                torch.empty_like(x, dtype=torch.float64),
                torch.empty_like(x, device="cpu"),
                torch.empty(2, 3, 16, 5, device=cuda).transpose(-1, -2)):
        with pytest.raises(ValueError, match="seq_cumsum"):
            tgrow._seq_cumsum_cuda(x, out=out)
    out = torch.empty_like(x)
    assert tgrow._seq_cumsum_cuda(x, out=out) is out
    assert _same_bits(out, tgrow._seq_cumsum_plain(x))
    before = tgrow.seq_cumsum.launches
    empty = torch.empty(3, 0, device=cuda)
    assert tgrow.seq_cumsum(empty).shape == (3, 0)
    assert tgrow.seq_cumsum.launches == before


@pytest.mark.parametrize("d,F,B", [(0, 50, 256), (3, 50, 256),
                                   (5, 136, 256), (2, 12, 64)])
def test_level_update_same_heap_on_card_and_cpu(cuda, d, F, B):
    """``_level_update`` of one level histogram ``[F, 2K, B]`` writes the
    same heap and decision table on the card (two kernel S launches) as
    on the CPU (the plain loop), bit for bit."""
    rng = np.random.RandomState(d + F + B)
    K = 1 << d
    g = rng.randn(F, K, B).astype(np.float32)
    h = rng.uniform(0.0, 2.0, size=(F, K, B)).astype(np.float32)
    g[:, :, ::7] = 0.0
    histC = np.concatenate([g, h], axis=1)
    Gtot = g[0].sum(axis=1) + rng.uniform(-0.5, 0.5, K).astype(np.float32)
    Htot = h[0].sum(axis=1) + rng.uniform(0.0, 0.5, K).astype(np.float32)
    cuts = np.sort(rng.randn(F, B).astype(np.float32), axis=1)
    cfg = tgrow.GrowParams(max_depth=6, split=TSplitParams())
    outs = []
    for dev in (cuda, torch.device("cpu")):
        st = tgf._init_state(cfg, torch.tensor([0.0, 1.0], device=dev))
        st.node_g[K - 1:2 * K - 1] = torch.as_tensor(Gtot, device=dev)
        st.node_h[K - 1:2 * K - 1] = torch.as_tensor(Htot, device=dev)
        before = tgrow.seq_cumsum.launches
        out = tgf._level_update(st, torch.as_tensor(histC, device=dev),
                                torch.as_tensor(cuts, device=dev), cfg, d)
        assert tgrow.seq_cumsum.launches - before == (2 if dev == cuda
                                                      else 0)
        outs.append({f: getattr(out, f).cpu() for f in out._fields})
    assert bool(outs[1]["is_split"].any())
    for f, got in outs[0].items():
        want = outs[1][f]
        assert got.dtype == want.dtype and torch.equal(
            got.view(torch.int32) if got.dtype == torch.float32 else got,
            want.view(torch.int32) if want.dtype == torch.float32 else want), f


def test_scan_launches_twelve_in_a_depth_6_tree(cuda):
    """An unprofiled depth-6 tree on the main path launches kernel S 12
    times, two scans a level (``with_missing`` and ``eval_splits``), and
    grows the CPU's tree."""
    import json

    import xgboost_tpu_torch as xgbt

    rng = np.random.RandomState(12)
    X = rng.randn(20_000, 10).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 6}
    dtrain = xgbt.DMatrix(X, y, device=cuda)
    before = tgrow.seq_cumsum.launches
    bst = xgbt.train(params, dtrain, 1, verbose_eval=False)
    torch.cuda.synchronize()
    assert tgrow.seq_cumsum.launches - before == 12
    cpu = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 1,
                     verbose_eval=False)

    def trees(b):
        return json.loads(b.save_raw())["learner"]["gradient_booster"][
            "model"]["trees"]

    assert trees(bst) == trees(cpu)

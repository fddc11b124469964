"""Port parity for the hoisted one-hot route (kernels C and D's plain
versions) against the JAX package.

- ``build_onehot``'s plain version against ``_build_onehot_pallas`` (Pallas
  interpret mode, the real kernel body) and ``_build_onehot_xla``: the same
  cells, bitwise, for uint8 bins at B = 16 and int16 bins at B = 256 with
  missing values (the port keeps the one-hot feature-major, ``[Fh*B, n_pad]``,
  the JAX package row-major, ``[n, Fh*B]``), and the padding rows zero;
- ``hoisted_level``'s plain version against ``_hoisted_level_pallas`` in
  interpret mode fed by ``_build_onehot_pallas``, full and partial hoist,
  levels d = 0..3 with random decision tables: ``pos`` equal; ``hist``
  bitwise equal for count-valued g/h; for random f32 g/h within 2^-15 of
  each bin's sum of |g| (resp. |h|), the TPU kernel's bf16 hi/lo split
  being exact to about 2^-16 per term (as ``test_torch_hist_kernel.py``
  states); and against the port's construct route (``_fused_level_plain``):
  the int64 sums bitwise equal;
- both level routes on categorical decision tables ``[Kp, 5+B]`` (column 4
  flags a categorical node, columns 5 on its right-going set): the port's
  plain versions against ``_fused_level_pallas`` and
  ``_hoisted_level_pallas`` in interpret mode, levels d = 0..3 with
  count-valued g/h: ``pos`` and ``hist`` bitwise equal;
- ``hoist_plan`` against the JAX plan (``use_pallas`` patched on) under the
  same ``XGBTPU_HOIST_BUDGET_MB``, at shapes the JAX VMEM model admits;
- route independence: 3 boosting rounds on the CPU through the hoisted route
  (full and partial) and the construct route grow identical heap trees;
- kernel D's per-row channel records (``_channel_records_plain``): the four
  digits of each lane recombine to ``q`` exactly, at ``|q|`` up to 2^30 of
  both signs too, and rows off the level get node -1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu.tree import hist_kernel as jhk
from xgboost_tpu_torch.data import quantile as tq
from xgboost_tpu_torch.tree import hist_kernel as thk

torch.set_num_threads(1)

N, F = 2048, 5  # N is a multiple of both Pallas row tiles (1024 and 512)


def _bins(rng, n, F, B):
    """Bins with the missing id B in their storage type: uint8 up to
    B = 254, int16 above (``quantile.storage_dtype``)."""
    dt = np.uint8 if B + 1 <= 255 else np.int16
    return rng.randint(0, B + 1, size=(n, F)).astype(dt)


def _gh(rng, n, count_valued):
    if count_valued:
        g = rng.randint(-3, 4, size=n).astype(np.float32)
        h = rng.randint(0, 5, size=n).astype(np.float32)
    else:
        g = rng.randn(n).astype(np.float32)
        h = rng.uniform(0.01, 0.25, size=n).astype(np.float32)
    return np.stack([g, h], axis=1)


def _ptab(rng, Kp, B):
    if Kp == 0:
        return np.zeros((1, 4), np.float32)
    return np.stack([
        (rng.rand(Kp) < 0.8).astype(np.float32),
        rng.randint(0, F, Kp).astype(np.float32),
        rng.randint(0, B, Kp).astype(np.float32),
        (rng.rand(Kp) < 0.5).astype(np.float32),
    ], axis=1)


@pytest.mark.parametrize("B,Fh", [(16, 5), (16, 2), (256, 3)])
def test_build_onehot_matches_pallas_interpret_and_xla(monkeypatch, B, Fh):
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    rng = np.random.RandomState(B + Fh)
    bins = _bins(rng, N, F, B)
    bins[rng.rand(N) < 0.05] = B  # whole rows missing, too
    got = thk.build_onehot(torch.from_numpy(bins), B=B, Fh=Fh).numpy()
    assert got.shape == (Fh * B, thk.onehot_rows(N)) and got.dtype == np.int8
    jb = jnp.asarray(bins[:, :Fh].astype(np.int32))
    want = np.asarray(jhk._build_onehot_pallas(jb, B=B,
                                               tr=jhk._build_tr(N, Fh, B)))
    np.testing.assert_array_equal(got[:, :N].T, want)
    np.testing.assert_array_equal(
        want, np.asarray(jhk._build_onehot_xla(jb, B=B)))


def test_build_onehot_pads_ragged_rows_with_zeros():
    rng = np.random.RandomState(3)
    n, B = 45, 16
    bins = _bins(rng, n, 3, B)
    oh = thk.build_onehot(torch.from_numpy(bins), B=B, Fh=2).numpy()
    assert oh.shape == (2 * B, 64)
    assert not oh[:, n:].any()
    # every present bin is one cell, missing none
    np.testing.assert_array_equal(oh[:, :n].reshape(2, B, n).sum(axis=1),
                                  (bins[:, :2] < B).T)


def _port_level(bins, onehot, pos, gh, ptab, K, Kp, B, d):
    gq = thk.quantize_gradients(torch.from_numpy(gh[:, 0]),
                                torch.from_numpy(gh[:, 1]))
    args = (torch.from_numpy(bins), torch.from_numpy(pos), gq,
            torch.from_numpy(ptab))
    kw = dict(K=K, Kp=Kp, B=B, d=d)
    p, hq = thk.hoisted_level(args[0], onehot, *args[1:], **kw)
    pc, hc = thk._fused_level_plain(*args, **kw)
    assert torch.equal(p, pc)
    assert torch.equal(hq, hc), "hoisted and construct int64 sums differ"
    _, h = thk.fused_level(*args, onehot=onehot, **kw)
    return p.numpy(), h.numpy()


@pytest.mark.parametrize("count_valued", [True, False])
@pytest.mark.parametrize("B,Fh", [(16, F), (16, 3), (256, F), (256, 2)])
def test_hoisted_level_matches_pallas_interpret(monkeypatch, count_valued, B,
                                                Fh):
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    rng = np.random.RandomState(31 + B + Fh + count_valued)
    bins = _bins(rng, N, F, B)
    gh = _gh(rng, N, count_valued)
    onehot = thk.build_onehot(torch.from_numpy(bins), B=B, Fh=Fh)
    bins32 = jnp.asarray(bins.astype(np.int32))
    j_onehot = jhk._build_onehot_pallas(bins32[:, :Fh], B=B,
                                        tr=jhk._build_tr(N, Fh, B))
    pos = np.zeros((N, 1), np.int32)
    for d in range(4):
        K, Kp = 1 << d, (1 << d) >> 1
        ptab = _ptab(rng, Kp, B)
        t_pos, t_hist = _port_level(bins, onehot, pos, gh, ptab, K, Kp, B, d)
        p_pos, p_hist = jhk._hoisted_level_pallas(
            bins32, j_onehot, jnp.asarray(pos), jnp.asarray(gh),
            jnp.asarray(ptab), K=K, Kp=Kp, B=B, d=d)
        np.testing.assert_array_equal(t_pos, np.asarray(p_pos))
        assert t_hist.shape == (F, 2 * K, B) and t_hist.dtype == np.float32
        if count_valued:
            np.testing.assert_array_equal(t_hist, np.asarray(p_hist))
        else:
            _, abs_hist = _port_level(bins, onehot, pos, np.abs(gh), ptab, K,
                                      Kp, B, d)
            err = np.abs(t_hist - np.asarray(p_hist))
            assert (err <= 2.0 ** -15 * abs_hist + 1e-7).all(), err.max()
        pos = t_pos


def _cat_ptab(rng, Kp, B):
    """A ``[max(Kp, 1), 5+B]`` table: node 0 and about half the others
    categorical, each set about 40% of the bins (all zero at level 0)."""
    base = _ptab(rng, Kp, B)
    if Kp == 0:
        return np.zeros((1, 5 + B), np.float32)
    wide = np.concatenate([base, rng.rand(Kp, 1) < 0.5,
                           rng.rand(Kp, B) < 0.4], axis=1).astype(np.float32)
    wide[0, 0] = wide[0, 4] = 1.0
    return wide


@pytest.mark.parametrize("route,B,Fh", [
    ("construct", 16, 0), ("construct", 64, 0),
    ("hoisted", 16, F), ("hoisted", 16, 3), ("hoisted", 256, 2),
])
def test_level_routes_categorical_table_match_pallas_interpret(
        monkeypatch, route, B, Fh):
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    rng = np.random.RandomState(77 + B + Fh)
    bins = _bins(rng, N, F, B)
    gh = _gh(rng, N, count_valued=True)
    bins32 = jnp.asarray(bins.astype(np.int32))
    if route == "hoisted":
        onehot = thk.build_onehot(torch.from_numpy(bins), B=B, Fh=Fh)
        j_onehot = jhk._build_onehot_pallas(bins32[:, :Fh], B=B,
                                            tr=jhk._build_tr(N, Fh, B))
    pos = np.zeros((N, 1), np.int32)
    for d in range(4):
        K, Kp = 1 << d, (1 << d) >> 1
        ptab = _cat_ptab(rng, Kp, B)
        assert ptab.shape[1] == 5 + B
        if route == "hoisted":
            t_pos, t_hist = _port_level(bins, onehot, pos, gh, ptab, K, Kp,
                                        B, d)
            p_pos, p_hist = jhk._hoisted_level_pallas(
                bins32, j_onehot, jnp.asarray(pos), jnp.asarray(gh),
                jnp.asarray(ptab), K=K, Kp=Kp, B=B, d=d)
        else:
            gq = thk.quantize_gradients(torch.from_numpy(gh[:, 0]),
                                        torch.from_numpy(gh[:, 1]))
            tp, th = thk.fused_level(torch.from_numpy(bins),
                                     torch.from_numpy(pos), gq,
                                     torch.from_numpy(ptab), K=K, Kp=Kp, B=B,
                                     d=d)
            t_pos, t_hist = tp.numpy(), th.numpy()
            p_pos, p_hist = jhk._fused_level_pallas(
                bins32, jnp.asarray(pos), jnp.asarray(gh), jnp.asarray(ptab),
                K=K, Kp=Kp, B=B, d=d)
        np.testing.assert_array_equal(t_pos, np.asarray(p_pos))
        np.testing.assert_array_equal(t_hist, np.asarray(p_hist))
        if Kp:  # the sets decide: read as numerical, rows go elsewhere
            num = thk.partition_apply(torch.from_numpy(bins),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(ptab[:, :4].copy()),
                                      Kp=Kp, B=B, d=d)
            assert not np.array_equal(num.numpy(), t_pos)
        pos = t_pos


@pytest.mark.parametrize("budget_mb,B,want", [
    (8 * 1024, 64, 50),   # full hoist: 2^20 rows x 64 B per feature fit
    (1024, 64, 16),       # partial: 16 features of 64 MiB each
    (128, 64, 0),         # 2 features: below the floor of 4, no hoist
    (0, 64, 0),           # disabled
    (1024, 16, 50),       # full hoist at a narrow bin count
])
def test_hoist_plan_matches_jax(monkeypatch, budget_mb, B, want):
    monkeypatch.setattr(jhk, "use_pallas", lambda: True)
    monkeypatch.setenv("XGBTPU_HOIST_BUDGET_MB", str(budget_mb))
    n, F_ = 1 << 20, 50
    got = thk.hoist_plan(n, F_, B, "cuda")
    assert got == jhk.hoist_plan(n, F_, B) == want
    assert thk.can_hoist(n, F_, B, "cuda") == jhk.can_hoist(n, F_, B)
    assert thk.hoist_budget_bytes("cuda") == jhk.hoist_budget_bytes()
    # the CPU never hoists, as the JAX package off the TPU
    assert thk.hoist_plan(n, F_, B, "cpu") == 0


def _heaps(bst):
    fields = ("keep", "feature", "split_bin", "split_cond", "default_left",
              "node_weight", "loss_chg", "node_h", "leaf_value")
    return [{f: getattr(e, f).numpy() for f in fields}
            for e in bst._gbm.model._entries]


def test_hoisted_and_construct_routes_grow_identical_trees(monkeypatch):
    rng = np.random.RandomState(9)
    n, nf, B = 3000, 7, 64
    X = rng.randn(n, nf).astype(np.float32)
    X[rng.rand(n, nf) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rng.randn(nf)) > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 4, "max_bin": B,
              "eta": 0.3}
    calls = []
    plain = thk._hoisted_level_plain

    def counted(*a, **k):
        calls.append(a[1].shape[0] // B)
        return plain(*a, **k)

    monkeypatch.setattr(thk, "_hoisted_level_plain", counted)
    heaps = {}
    for fh in (0, nf, 4):  # construct, full hoist, partial hoist
        monkeypatch.setattr(tq, "hoist_plan", lambda *a, fh=fh: fh)
        calls.clear()
        bst = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 3,
                         verbose_eval=False)
        assert calls == [fh] * (3 * 4 if fh else 0)
        heaps[fh] = _heaps(bst)
    for fh in (nf, 4):
        assert len(heaps[fh]) == len(heaps[0]) == 3
        for a, b in zip(heaps[fh], heaps[0]):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _digits(words: torch.Tensor) -> torch.Tensor:
    """int32 words of four packed bytes -> [n, 4] signed digits, lowest
    first."""
    w = words.long() & 0xFFFFFFFF
    return torch.stack([(((w >> (8 * k)) & 0xFF) ^ 0x80) - 0x80
                        for k in range(4)], dim=1)


@pytest.mark.parametrize("d", [0, 3])
def test_channel_records_recombine_to_q_and_mark_rows_off_level(d):
    rng = np.random.RandomState(5 + d)
    n, K = 4096, 1 << d
    big = 1 << 30
    edges = np.array([big, -big, big - 1, -(big - 1), 0, 1, -1, 127, 128,
                      -128, -129, 255, 256, -256, (1 << 24) - 1, -(1 << 24),
                      0x3F7F7F7F, -0x3F7F7F7F, big - 128, -(big - 129)])
    q = rng.randint(-big, big + 1, size=(n, 2)).astype(np.int64)
    q[:len(edges), 0] = edges
    q[:len(edges), 1] = -edges[::-1]
    # positions at this level, at the levels before it (leaves kept) and
    # past it
    pos = rng.randint(0, 2 * K + 1, size=(n, 1)).astype(np.int32)
    gq = thk.QuantizedGradients(q=torch.from_numpy(q.astype(np.int32)),
                                exp=torch.zeros(2, dtype=torch.int32))
    rec = thk._channel_records_plain(torch.from_numpy(pos), gq, K=K, d=d)
    assert rec.shape == (n, 4) and rec.dtype == torch.int32
    local = pos[:, 0] - (K - 1)
    want_local = np.where((local >= 0) & (local < K), local, -1)
    np.testing.assert_array_equal(rec[:, 0].numpy(), want_local)
    assert (rec[:, 0] == -1).any() and (rec[:, 0] >= 0).any()
    assert (rec[:, 3] == 0).all()
    scale = torch.tensor([1, 1 << 8, 1 << 16, 1 << 24])
    for lane in range(2):
        dg = _digits(rec[:, 1 + lane])
        assert (dg[:, :3] >= -128).all() and (dg[:, :3] <= 127).all()
        assert dg[:, 3].abs().max() <= 65
        np.testing.assert_array_equal((dg * scale).sum(dim=1).numpy(),
                                      q[:, lane])

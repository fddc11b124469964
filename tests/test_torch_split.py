"""Port parity: split evaluation and the level update against the JAX
package on the same histogram.

``eval_splits`` and ``_level_update`` of both packages get identical numpy
histograms and node totals. The winning feature, bin and missing direction
must be identical (the port keeps the strict left-to-right f32 cumsum and
the first-maximum argmax over the flattened [2, F, B] scores, missing-right
first); loss_chg agrees within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_tpu.tree import grow as jgrow
from xgboost_tpu.tree import grow_fused as jgf
from xgboost_tpu.tree.param import SplitParams as JSplitParams
from xgboost_tpu_torch.tree import grow as tgrow
from xgboost_tpu_torch.tree import grow_fused as tgf
from xgboost_tpu_torch.tree.param import SplitParams as TSplitParams

torch.set_num_threads(1)

K, F, B = 4, 6, 16
PARAMS = [dict(), dict(reg_lambda=0.5, reg_alpha=0.3, min_child_weight=2.0),
          dict(max_delta_step=0.7)]


def _hist(seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(K, F, B + 1).astype(np.float32)
    h = rng.uniform(0.0, 3.0, size=(K, F, B + 1)).astype(np.float32)
    h[:, 2, :] = 0.0  # a feature that can never satisfy min_child_weight
    g[1, :, :4] = 0.0  # ties inside one node
    h[1, :, :4] = 1.0
    return np.stack([g, h], axis=-1)


@pytest.mark.parametrize("pk", range(len(PARAMS)))
def test_eval_splits_same_decision(pk):
    hist = _hist(pk)
    G = hist[..., 0].sum(axis=(2,))[:, 0]
    H = hist[..., 1].sum(axis=(2,))[:, 0]
    fmask = np.ones((K, F), bool)
    fmask[3, 1] = False
    jd = jgrow.eval_splits(jnp.asarray(hist), jnp.asarray(G), jnp.asarray(H),
                           JSplitParams(**PARAMS[pk]), jnp.asarray(fmask), B)
    td = tgrow.eval_splits(torch.from_numpy(hist), torch.from_numpy(G),
                           torch.from_numpy(H), TSplitParams(**PARAMS[pk]),
                           torch.from_numpy(fmask), B)
    for name in ("f", "b", "dir"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)), name)
    np.testing.assert_allclose(td.loss.numpy(), np.asarray(jd.loss), rtol=1e-6)
    np.testing.assert_allclose(td.GL.numpy(), np.asarray(jd.GL), rtol=1e-6)
    np.testing.assert_allclose(td.HL.numpy(), np.asarray(jd.HL), rtol=1e-6)
    np.testing.assert_allclose(td.w_node.numpy(), np.asarray(jd.w_node),
                               rtol=1e-6)


def test_seq_cumsum_is_strictly_sequential_f32():
    x = np.full((3, 4096), 0.1, np.float32)
    got = tgrow.seq_cumsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jgrow.seq_cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.add.accumulate(x, axis=1,
                                                         dtype=np.float32))


def _edge_rows(B):
    """Rows of the edge values at width ``B``: a leading -0.0, +-inf and
    their NaN, a NaN mid-row, subnormal inputs and sums."""
    tiny = np.finfo(np.float32).tiny
    rng = np.random.RandomState(B)
    x = rng.randn(8, B).astype(np.float32)
    x[0, :] = -0.0
    x[1, 0] = -0.0
    x[2, 0] = np.inf
    x[3, :2] = [np.inf, -np.inf][:B]
    x[4, B // 2] = np.nan
    x[5, 0] = -np.inf
    x[6, :] = tiny * 0.375
    x[7, ::2] = 1.25 * tiny
    x[7, 1::2] = -1.125 * tiny
    return x


def _scan_case(name):
    rng = np.random.RandomState(len(name))
    if name == "with_missing":  # [2, K, F, B]: g and h lanes
        return rng.randn(2, K, F, B).astype(np.float32)
    if name == "partition":  # [4, K, F, B]: the sorted categories too
        x = rng.randn(4, K, F, B).astype(np.float32)
        x[1::2] = np.abs(x[1::2])
        x[:, 0, 0, 0] = -0.0
        return x
    return _edge_rows(int(name[1:]))


def _ftz(a):
    """x86 flush-to-zero of float32 subnormals, keeping the sign."""
    return np.where(np.abs(a) < np.finfo(np.float32).tiny,
                    np.copysign(np.float32(0.0), a), a).astype(np.float32)


@pytest.mark.parametrize("case", ["B1", "B2", "B5", "B257", "with_missing",
                                  "partition"])
def test_seq_cumsum_bits_match_jax_and_numpy(case):
    """The plain ``seq_cumsum`` (what kernel S must reproduce on the card)
    bit for bit: against ``np.add.accumulate`` in float32 of each row
    behind a +0.0 (the loop starts from +0.0, so a leading -0.0 sums to
    +0.0; NaNs keep the same bits), and against the JAX package's
    ``seq_cumsum``. XLA's CPU runtime flushes subnormal inputs and results
    to zero, where the port keeps IEEE subnormals; so the JAX package is
    held to the same loop with each add's operands and result flushed."""
    x = _scan_case(case)
    got = tgrow.seq_cumsum(torch.from_numpy(x)).numpy()
    zero = np.zeros(x.shape[:-1] + (1,), np.float32)
    with np.errstate(invalid="ignore"):
        want = np.add.accumulate(np.concatenate([zero, x], axis=-1),
                                 axis=-1, dtype=np.float32)[..., 1:]
        flushed = np.empty_like(x)
        acc = zero[..., 0]
        for b in range(x.shape[-1]):
            acc = _ftz(acc + _ftz(x[..., b]))
            flushed[..., b] = acc
    jax_got = np.asarray(jgrow.seq_cumsum(jnp.asarray(x)))
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(jax_got.view(np.uint32),
                                  flushed.view(np.uint32))
    if case.startswith("B"):
        assert got.view(np.uint32)[0, 0] == 0  # +0.0 from a leading -0.0
        assert np.all(got[6] != 0.0) and np.all(flushed[6] == 0.0)


@pytest.mark.parametrize("d", [0, 2])
def test_level_update_same_heap(d):
    """Both packages' _level_update on the same [F, 2K, B] level histogram
    and the same parent state write the same splits, conditions, default
    directions and decision table."""
    rng = np.random.RandomState(d)
    Kd = 1 << d
    max_depth = 3
    g = rng.randn(F, Kd, B).astype(np.float32)
    h = rng.uniform(0.0, 2.0, size=(F, Kd, B)).astype(np.float32)
    histC = np.concatenate([g, h], axis=1)  # [F, 2K, B]
    # node totals include a little missing mass on top of feature 0's bins
    Gtot = g[0].sum(axis=1) + rng.uniform(-0.5, 0.5, Kd).astype(np.float32)
    Htot = h[0].sum(axis=1) + rng.uniform(0.0, 0.5, Kd).astype(np.float32)
    cuts = np.sort(rng.randn(F, B).astype(np.float32), axis=1)

    jcfg = jgrow.GrowParams(max_depth=max_depth, split=JSplitParams())
    jst = jgf._init_state(jcfg, F, jnp.float32(0.0), jnp.float32(1.0))
    off = Kd - 1
    jst = jst._replace(node_g=jst.node_g.at[off:off + Kd].set(Gtot),
                       node_h=jst.node_h.at[off:off + Kd].set(Htot))
    jout = jgf._level_update(jst, jnp.asarray(histC), jnp.asarray(cuts),
                             jnp.ones((F,), bool), jax.random.PRNGKey(0),
                             jcfg, d)

    tcfg = tgrow.GrowParams(max_depth=max_depth, split=TSplitParams())
    tst = tgf._init_state(tcfg, torch.tensor([0.0, 1.0]))
    tst.node_g[off:off + Kd] = torch.from_numpy(Gtot)
    tst.node_h[off:off + Kd] = torch.from_numpy(Htot)
    tout = tgf._level_update(tst, torch.from_numpy(histC),
                             torch.from_numpy(cuts), tcfg, d)

    for name in ("is_split", "feature", "split_bin", "split_cond",
                 "default_left", "ptab"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)), name)
    for name in ("node_g", "node_h", "node_w", "loss_chg"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)

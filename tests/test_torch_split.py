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

"""Port parity: the level kernel's plain version against the JAX package.

``xgboost_tpu_torch.tree.hist_kernel.fused_level`` on CPU tensors (the
plain version of kernel A) against ``xgboost_tpu``'s
``_fused_level_pallas`` run in interpret mode (the real Pallas kernel body)
and against ``fused_level_xla``, at levels d = 0..3 with random decision
tables, on the same numpy inputs:

- ``pos`` exactly equal;
- ``hist`` exactly equal for count-valued g/h (all three sum integers
  exactly);
- for random f32 g/h, rtol 1e-5 against the XLA route (the port sums
  fixed-point integers with 2^-30 relative resolution per row, XLA sums f32
  in row order; the atol of 1e-6 covers bins whose sum cancels to near
  zero), and against the Pallas kernel within 2^-15 of each bin's sum of
  |g| (resp. |h|): its hi/lo bf16 split keeps each term exact only to about
  2^-16 relative (``hist_kernel.py:9-15``), so its error scales with the
  terms, not with their (possibly cancelling) sum.

The same holds against the TPU's hoisted route to that contract,
``_build_onehot_pallas`` feeding ``_hoisted_level_pallas`` (interpret mode,
full and partial hoist): kernel A replaces both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_tpu.tree import hist_kernel as jhk
from xgboost_tpu_torch.tree import hist_kernel as thk

torch.set_num_threads(1)

N, F, B = 2048, 5, 16  # N is a multiple of the Pallas row tile (1024)


def _inputs(seed, count_valued):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B + 1, size=(N, F)).astype(np.uint8)  # B = missing
    if count_valued:
        g = rng.randint(-3, 4, size=N).astype(np.float32)
        h = rng.randint(0, 5, size=N).astype(np.float32)
    else:
        g = rng.randn(N).astype(np.float32)
        h = rng.uniform(0.01, 0.25, size=N).astype(np.float32)
    return rng, bins, np.stack([g, h], axis=1)


def _ptab(rng, Kp):
    if Kp == 0:
        return np.zeros((1, 4), np.float32)
    return np.stack([
        (rng.rand(Kp) < 0.8).astype(np.float32),
        rng.randint(0, F, Kp).astype(np.float32),
        rng.randint(0, B, Kp).astype(np.float32),
        (rng.rand(Kp) < 0.5).astype(np.float32),
    ], axis=1)


def _port_level(bins, pos, gh, ptab, K, Kp, d):
    gq = thk.quantize_gradients(torch.from_numpy(gh[:, 0]),
                                torch.from_numpy(gh[:, 1]))
    p, h = thk.fused_level(torch.from_numpy(bins), torch.from_numpy(pos), gq,
                           torch.from_numpy(ptab), K=K, Kp=Kp, B=B, d=d)
    return p.numpy(), h.numpy()


@pytest.mark.parametrize("count_valued", [True, False])
def test_fused_level_matches_pallas_interpret_and_xla(monkeypatch,
                                                      count_valued):
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    rng, bins, gh = _inputs(11 + count_valued, count_valued)
    pos = np.zeros((N, 1), np.int32)
    for d in range(4):
        K, Kp = 1 << d, (1 << d) >> 1
        ptab = _ptab(rng, Kp)
        t_pos, t_hist = _port_level(bins, pos, gh, ptab, K, Kp, d)
        x_pos, x_hist = jhk.fused_level_xla(
            jnp.asarray(bins), jnp.asarray(pos), jnp.asarray(gh),
            jnp.asarray(ptab), K=K, Kp=Kp, B=B, d=d)
        p_pos, p_hist = jhk._fused_level_pallas(
            jnp.asarray(bins.astype(np.int32)), jnp.asarray(pos),
            jnp.asarray(gh), jnp.asarray(ptab), K=K, Kp=Kp, B=B, d=d)
        np.testing.assert_array_equal(t_pos, np.asarray(x_pos))
        np.testing.assert_array_equal(t_pos, np.asarray(p_pos))
        assert t_hist.shape == (F, 2 * K, B) and t_hist.dtype == np.float32
        if count_valued:
            np.testing.assert_array_equal(t_hist, np.asarray(x_hist))
            np.testing.assert_array_equal(t_hist, np.asarray(p_hist))
        else:
            np.testing.assert_allclose(t_hist, np.asarray(x_hist),
                                       rtol=1e-5, atol=1e-6)
            _, abs_hist = _port_level(bins, pos, np.abs(gh), ptab, K, Kp, d)
            err = np.abs(t_hist - np.asarray(p_hist))
            assert (err <= 2.0 ** -15 * abs_hist + 1e-7).all(), err.max()
        pos = t_pos


@pytest.mark.parametrize("count_valued", [True, False])
@pytest.mark.parametrize("Fh", [F, 3])  # full hoist, partial hoist
def test_fused_level_matches_hoisted_pallas_interpret(monkeypatch,
                                                      count_valued, Fh):
    """The TPU's other route to the same (pos, hist) contract: the one-hot
    built by ``_build_onehot_pallas`` and streamed by
    ``_hoisted_level_pallas`` (both real kernel bodies, interpret mode).
    Kernel A reads the bins directly, so this one contract covers both."""
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    rng, bins, gh = _inputs(21 + count_valued, count_valued)
    bins32 = jnp.asarray(bins.astype(np.int32))
    onehot = jhk._build_onehot_pallas(bins32[:, :Fh], B=B,
                                      tr=jhk._build_tr(N, Fh, B))
    np.testing.assert_array_equal(
        np.asarray(onehot),
        np.asarray(jhk._build_onehot_xla(jnp.asarray(bins[:, :Fh]), B=B)))
    pos = np.zeros((N, 1), np.int32)
    for d in range(4):
        K, Kp = 1 << d, (1 << d) >> 1
        ptab = _ptab(rng, Kp)
        t_pos, t_hist = _port_level(bins, pos, gh, ptab, K, Kp, d)
        p_pos, p_hist = jhk._hoisted_level_pallas(
            bins32, onehot, jnp.asarray(pos), jnp.asarray(gh),
            jnp.asarray(ptab), K=K, Kp=Kp, B=B, d=d)
        np.testing.assert_array_equal(t_pos, np.asarray(p_pos))
        assert np.asarray(p_hist).shape == t_hist.shape
        if count_valued:
            np.testing.assert_array_equal(t_hist, np.asarray(p_hist))
        else:
            _, abs_hist = _port_level(bins, pos, np.abs(gh), ptab, K, Kp, d)
            err = np.abs(t_hist - np.asarray(p_hist))
            assert (err <= 2.0 ** -15 * abs_hist + 1e-7).all(), err.max()
        pos = t_pos


def test_plain_version_is_deterministic_and_quantiser_bounds():
    rng, bins, gh = _inputs(5, False)
    gq = thk.quantize_gradients(torch.from_numpy(gh[:, 0]),
                                torch.from_numpy(gh[:, 1]))
    assert gq.q.dtype == torch.int32
    assert int(gq.q.abs().max()) <= 1 << 30
    # the largest |x| of each lane uses at least half the range
    assert (gq.q.abs().amax(dim=0) >= 1 << 29).all()
    # totals come from the integers: they equal the f64 sum within one
    # quantisation step per row plus the final rounding to f32
    exact = gh.astype(np.float64).sum(axis=0)
    step = np.ldexp(1.0, -gq.exp.numpy().astype(np.int64))
    tol = N * step + np.abs(exact) * np.finfo(np.float32).eps
    assert (np.abs(gq.totals().numpy() - exact) <= tol).all()
    ptab = _ptab(rng, 2)
    pos = rng.randint(0, 3, size=(N, 1)).astype(np.int32)
    a = _port_level(bins, pos, gh, ptab, 4, 2, 2)
    b = _port_level(bins, pos, gh, ptab, 4, 2, 2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_partition_apply_matches_xla_with_missing_and_non_split_nodes():
    rng, bins, _ = _inputs(7, True)
    for d in (1, 2, 3):
        Kp = 1 << (d - 1)
        ptab = _ptab(rng, Kp)
        pos = rng.randint(0, (1 << d) - 1, size=(N, 1)).astype(np.int32)
        want = jhk.partition_apply_xla(jnp.asarray(bins), jnp.asarray(pos),
                                       jnp.asarray(ptab), Kp=Kp, B=B, d=d)
        got = thk.partition_apply(torch.from_numpy(bins),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(ptab), Kp=Kp, B=B, d=d)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_leaf_delta_matches_gather():
    rng = np.random.RandomState(3)
    lv = rng.randn(15).astype(np.float32)
    pos = rng.randint(0, 15, size=(100, 1)).astype(np.int32)
    got = thk.leaf_delta(torch.from_numpy(pos), torch.from_numpy(lv)).numpy()
    want = np.asarray(jhk.leaf_delta(jnp.asarray(pos), jnp.asarray(lv), 128,
                                     pallas=False))
    np.testing.assert_array_equal(got, want)

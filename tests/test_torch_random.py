"""Port parity: the threefry stream against ``jax.random``.

``xgboost_tpu_torch.threefry`` must give ``jax.random``'s bits exactly
(the JAX package's default threefry2x32, partitionable stream): keys,
``split``, ``fold_in``, 32-bit ``bits``, float32 ``uniform`` on [0, 1)
(compared as bit patterns; another range within 1 ulp of its width),
``bernoulli`` and ``permutation`` at F = 6, 50 and 2,000 (2,000 takes two
shuffle rounds), ``randint`` (the linear booster's random selector) at
spans 1 to 65,537 and 2^31 - 1. ``gumbel`` goes through two ``log``s,
whose last ulp may differ between torch and XLA: it is held within 4 ulps
of ``max(1, |g|)`` (2 measured). A draw of ``[n]`` is the first ``n``
values of a draw of ``[m > n]`` (the prefix property the port relies on
where the JAX package draws over padded rows or a fixed node width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_tpu_torch import threefry as tf

torch.set_num_threads(1)

SEEDS = [0, 3, 1000003 * 7 + 131, 0x7FFFFFFF]
SHAPES = [(6,), (50,), (2000,), (4, 50), (3, 5, 7)]


def _u32(a):
    return np.asarray(a).astype(np.int64)


def test_jax_uses_the_partitionable_stream():
    # the port implements the partitionable stream only; a JAX whose
    # default flips must fail here rather than draw other samples
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    assert tk.dtype == torch.int64 and tuple(tk.shape) == (2,)
    for n in (2, 3, 7):
        np.testing.assert_array_equal(tf.split(tk, n).numpy(),
                                      _u32(jax.random.split(jk, n)))
    for data in (0, 1, 5, 2 ** 31 + 7):
        np.testing.assert_array_equal(tf.fold_in(tk, data).numpy(),
                                      _u32(jax.random.fold_in(jk, data)))
    # nested, as the grower derives its node keys
    np.testing.assert_array_equal(
        tf.fold_in(tf.fold_in(tf.split(tk, 3)[2], 4), 1).numpy(),
        _u32(jax.random.fold_in(jax.random.fold_in(
            jax.random.split(jk, 3)[2], 4), 1)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_bernoulli_bitwise(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    np.testing.assert_array_equal(tf.random_bits(tk, shape).numpy(),
                                  _u32(jax.random.bits(jk, shape)))
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = tf.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    # another range: XLA may fuse the scale and the shift into one
    # rounding (an FMA), the port rounds each: within 1 ulp of the range's
    # width (the samplers draw only on [0, 1) and [tiny, 1), where both
    # are exact)
    tr = tf.uniform(tk, shape, minval=-2.0, maxval=3.0).numpy()
    jr = np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
    assert (np.abs(tr - jr) <= np.spacing(np.float32(5.0))).all()
    for p in (0.5, 0.7, 0.123):
        np.testing.assert_array_equal(
            tf.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("n", [1, 6, 50, 2000])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_bitwise(seed, n):
    got = tf.permutation(tf.prng_key(seed), n).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("n", [1, 2, 6, 50, 137, 65537])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed, n):
    """``jax.random.randint(key, (n,), 0, n)`` (the linear booster's random
    selector, keys folded per output group) and other ranges: two bit
    streams folded through the span multiplier, whose square wraps as
    uint32 (at n = 65537 it is 0)."""
    for k in (0, 2):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), k)
        got = tf.randint(tf.fold_in(tf.prng_key(seed), k), (n,), 0, n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(jk, (n,), 0, n)))
    for lo, hi in ((3, 10), (5, 5), (7, 2), (0, 2 ** 31 - 1)):
        np.testing.assert_array_equal(
            tf.randint(tf.prng_key(seed), (n,), lo, hi).numpy(),
            np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,),
                                          lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_4_ulps(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    for shape in ((6,), (50,), (2000,)):
        jg = np.asarray(jax.random.gumbel(jk, shape), np.float64)
        tg = tf.gumbel(tk, shape).numpy()
        assert tg.dtype == np.float32 and np.isfinite(tg).all()
        ulp = np.spacing(np.maximum(1.0, np.abs(jg)).astype(np.float32))
        assert (np.abs(tg - jg) <= 4 * ulp).all()


def test_prefix_property():
    k = tf.prng_key(11)
    np.testing.assert_array_equal(tf.uniform(k, (32, 50))[:4].numpy(),
                                  tf.uniform(k, (4, 50)).numpy())
    np.testing.assert_array_equal(tf.random_bits(k, (3000,))[:2048].numpy(),
                                  tf.random_bits(k, (2048,)).numpy())
    jk = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (32, 50)))[:4],
        np.asarray(jax.random.uniform(jk, (4, 50))))


def test_draws_follow_the_requested_device_and_keys_stay_on_the_host():
    """A draw lands on the device it is asked for (here the CPU and the
    shape-only 'meta' device, where the counters are built without data);
    keys and their derivations are [2] int64 tensors on the CPU, and the
    hash of host words equals the hash of the same words as tensors."""
    k = tf.prng_key(5)
    assert tf.uniform(k, (10,), device="meta").device.type == "meta"
    assert tf.uniform(k, (10,)).device.type == "cpu"
    for derived in (k, tf.split(k, 3)[1], tf.fold_in(k, 9)):
        assert derived.device.type == "cpu" and derived.dtype == torch.int64
    k1, k2 = (int(w) for w in k)
    for x in range(4):
        h = tf.threefry_2x32(k1, k2, 0, x)
        t = tf.threefry_2x32(k1, k2, torch.zeros(1, dtype=torch.int64),
                             torch.tensor([x]))
        assert h == tuple(int(w) for w in t)
    assert jnp.asarray(0).dtype == jnp.int32  # x64 stays off in the tests

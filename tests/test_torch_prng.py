"""The threefry twin (``repro_torch.prng``) against ``jax.random``.

jax runs with ``jax_threefry_partitionable`` on (jax 0.9's default, and
set here explicitly).  Keys, ``split``, ``fold_in``, 32-bit bits,
``uniform`` and ``permutation`` must be equal bit for bit (keys on the
host, bulk draws through torch on the CPU); ``normal`` within
``chip_smoke.NORMAL_ULPS`` float32 ulps (XLA's ``log1p`` and its
multiply-adds round differently from torch's; 3 ulps seen here).  The
constants ``chip_smoke.py`` holds the card to are recomputed with jax.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import prng as jax_prng

from repro_torch import prng

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 2 ** 31 - 1, 2 ** 32 - 1)
FOLDS = (0, 7, 10_000, 10_003, 20_000, 20_009)
SHAPES = [(), (0,), (1,), (5,), (3, 7), (2, 0, 3), (4, 3, 5), (10, 33)]


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class JaxPRNG:
    """``chip_smoke.prng_recipe``'s api over jax.random (stacked keys are
    vmapped)."""

    def key(self, seed):
        return np.asarray(jax.random.PRNGKey(seed))

    def split(self, key, num):
        return np.asarray(jax.random.split(jnp.asarray(key), num))

    def fold_in(self, key, data):
        key = jnp.asarray(key)
        data = np.asarray(data)
        if key.ndim == 1 and data.ndim == 0:
            return np.asarray(jax.random.fold_in(key, int(data)))
        key, data = np.broadcast_arrays(np.asarray(key),
                                        data[..., None])
        flat_k = jnp.asarray(key.reshape(-1, 2))
        flat_d = jnp.asarray(data[..., 0].reshape(-1).astype(np.uint32))
        out = jax.vmap(jax.random.fold_in)(flat_k, flat_d)
        return np.asarray(out).reshape(key.shape)

    def bits(self, keys, shape):
        return np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(
            jnp.asarray(keys)))

    def uniform(self, keys, shape):
        return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
            jnp.asarray(keys)))

    def permutation(self, key, n):
        return np.asarray(jax.random.permutation(jnp.asarray(key), n))


def test_random123_known_answers():
    """threefry2x32-20 at Random123's three vectors, by the port and by
    jax's own hash."""
    for key, ctr, want in _smoke().THREEFRY_KAT:
        got = prng.threefry2x32(np.asarray(key, np.uint32), ctr[0], ctr[1],
                                "cpu")
        assert tuple(int(x) for x in got) == want
        ref = jax_prng.threefry_2x32(np.asarray(key, np.uint32),
                                     np.asarray(ctr, np.uint32))
        assert tuple(int(x) for x in np.asarray(ref)) == want


@pytest.mark.parametrize("seed", SEEDS + (-1, 12345))
def test_keys_split_and_fold_in_equal_jax(seed):
    k = jax.random.PRNGKey(seed)
    kp = prng.PRNGKey(seed)
    np.testing.assert_array_equal(kp, np.asarray(k))
    for num in (1, 2, 3, 10):
        np.testing.assert_array_equal(prng.split(kp, num),
                                      np.asarray(jax.random.split(k, num)))
    for d in FOLDS + (2 ** 32 - 1,):
        np.testing.assert_array_equal(prng.fold_in(kp, d),
                                      np.asarray(jax.random.fold_in(k, d)))
    # vectorised folds: a stack of keys, and keys x leaf indices
    ids = 10_000 + np.arange(7)
    stacked = prng.fold_in(kp, ids)
    np.testing.assert_array_equal(stacked, JaxPRNG().fold_in(np.asarray(k),
                                                             ids))
    per_leaf = prng.fold_in(stacked[:, None, :], np.arange(3))
    for i in range(7):
        for leaf in range(3):
            np.testing.assert_array_equal(
                per_leaf[i, leaf],
                np.asarray(jax.random.fold_in(jnp.asarray(stacked[i]),
                                              leaf)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_equal_jax(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 20_003)
    kp = np.asarray(k)
    want_b = np.asarray(jax.random.bits(k, shape))
    want_u = np.asarray(jax.random.uniform(k, shape))
    np.testing.assert_array_equal(
        prng.random_bits(kp, shape, "cpu").numpy(), want_b.astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(kp, shape, "cpu").numpy(),
                                  want_u)
    lo, hi = -2.5, 3.0
    np.testing.assert_array_equal(
        prng.uniform(kp, shape, "cpu", lo, hi).numpy(),
        np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi)))


def test_many_arrays_in_one_pass_equal_jax_per_key():
    """``uniform_many``: (N, L) keys, L shapes, one pass -> each (N,
    *shape_l) equals vmapped jax.random.uniform under its own keys."""
    rk = jax.random.PRNGKey(4)
    shapes = [(100,), (784, 100), (), (3, 0), (64, 10)]
    keys = prng.fold_in(prng.fold_in(np.asarray(rk), 20_000 + np.arange(6))
                        [:, None, :], np.arange(len(shapes)))
    got = prng.uniform_many(keys, shapes, "cpu")
    for li, s in enumerate(shapes):
        want = JaxPRNG().uniform(keys[:, li], s)
        assert tuple(got[li].shape) == (6,) + s
        np.testing.assert_array_equal(got[li].numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_stated_ulps_of_jax(seed):
    k = jax.random.PRNGKey(seed)
    shape = (64, 257)
    want = np.asarray(jax.random.normal(k, shape))
    got = prng.normal(np.asarray(k), shape, "cpu").numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= _smoke().NORMAL_ULPS


@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 600, 1625, 1626, 4099,
                               10_000])
def test_permutation_equals_jax(n):
    """One sorting round up to n = 1625, two from 1626 (the jax rule,
    ceil(3 ln n / ln(2**32 - 1))); stable sorts by fresh 32-bit keys."""
    for seed in (0, 2 ** 32 - 1):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), n)
        want = np.asarray(jax.random.permutation(k, n))
        kp = np.asarray(k)
        np.testing.assert_array_equal(
            prng.permutation(kp, n, "cpu").numpy(), want)
    assert prng.shuffle_rounds(1625) == 1 and prng.shuffle_rounds(1626) == 2


def test_chip_smoke_constants_equal_jax_and_the_port_on_cpu():
    """``chip_smoke.PRNG_VECTORS`` (what the card is held to) equals the
    recipe run through jax.random, and through the port on the CPU."""
    smoke = _smoke()
    assert smoke.prng_recipe(JaxPRNG()) == smoke.PRNG_VECTORS
    assert smoke.prng_recipe(smoke.PortPRNG("cpu")) == smoke.PRNG_VECTORS
    assert smoke.prng_phase("cpu")["normal_max_ulps"] <= smoke.NORMAL_ULPS

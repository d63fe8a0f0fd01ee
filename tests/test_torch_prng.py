"""The port's threefry2x32 stream (``repro_torch.core.prng``) against
``jax.random`` on the CPU (threefry2x32 with partitionable bits, jax's
default here): keys, ``fold_in`` (negative data included), raw bits and
uniforms are compared bitwise; the Gumbel noise passes through two float32
``log``\\ s, ATen's against XLA's, and is held to 1e-6 absolute (measured
here: up to 4.8e-7, with about 22 % of the values an ulp apart); the
categorical draws are compared exactly on the seeds below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

from _torch_threads import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 7, 42, 1234, 99991, 2 ** 31 - 1, -1, -77, 123456789]
SHAPES = [(1, 7), (3, 64), (8, 1000)]
GUMBEL_ATOL = 1e-6


def _bits(x) -> np.ndarray:
    """A jax uint32 array or a port int32 tensor as int32 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x).view(np.int32)


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    jk, k = _keys(seed)
    assert k.dtype == torch.int32 and k.shape == (2,)
    np.testing.assert_array_equal(_bits(k), _bits(jk))


@pytest.mark.parametrize("data", [0, 1, 5, 40, 2 ** 31 - 1, -1, -2, -12345,
                                  -(2 ** 31)])
def test_fold_in_matches_jax(data):
    """``data`` taken as uint32: a negative value wraps, as the reference's
    traced int32 step index does."""
    for seed in SEEDS:
        jk, k = _keys(seed)
        want = _bits(jax.random.fold_in(jk, jnp.int32(data)))
        np.testing.assert_array_equal(_bits(prng.fold_in(k, data)), want)
        t = torch.tensor(data, dtype=torch.int32)
        np.testing.assert_array_equal(_bits(prng.fold_in(k, t)), want)


def test_vector_fold_in_is_elementwise():
    """One fold-in over a vector of data gives each element's key (the
    engine folds a round's draws at once)."""
    jk, k = _keys(3)
    data = torch.arange(-5, 40, dtype=torch.int32) * 977
    keys = prng.fold_in(k, data)
    assert keys.shape == (45, 2)
    for d, got in zip(data.tolist(), keys):
        np.testing.assert_array_equal(
            _bits(got), _bits(jax.random.fold_in(jk, jnp.int32(d))))
    step0 = torch.full((), 11, dtype=torch.int32)
    np.testing.assert_array_equal(
        _bits(prng.fold_in(k, step0 + torch.arange(4, dtype=torch.int32))),
        np.stack([_bits(jax.random.fold_in(jk, 11 + i)) for i in range(4)]))


def test_fold_in_chain_matches_jax():
    jk, k = _keys(5)
    for d in (3, -9, 2 ** 30, 0, 17):
        jk, k = jax.random.fold_in(jk, jnp.int32(d)), prng.fold_in(k, d)
        np.testing.assert_array_equal(_bits(k), _bits(jk))


# known-answer vectors of threefry2x32 (20 rounds): the Random123 suite's,
# as jax's own tests carry them
KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
        (0x6B200159, 0x99BA4EFE)),
       ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
        (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
        (0xC4923A9C, 0x483DF7A0))]


def _i32(v):
    return torch.tensor(np.array([v], np.uint32).view(np.int32))


@pytest.mark.parametrize("key,count,want", KAT)
def test_threefry2x32_known_answers(key, count, want):
    k = torch.cat([_i32(key[0]), _i32(key[1])])
    y0, y1 = prng.threefry2x32(k, _i32(count[0]), _i32(count[1]))
    got = np.concatenate([y0.numpy(), y1.numpy()]).view(np.uint32)
    assert got.tolist() == list(want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed, shape):
    """The partitionable bits: element n hashes the counter (0, n), the two
    output words XORed."""
    jk, k = _keys(seed)
    got = prng.random_bits(k, shape)
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax.random.bits(jk, shape)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    jk, k = _keys(seed)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(k, shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    want = np.asarray(jax.random.uniform(jk, shape, minval=tiny, maxval=1.))
    got = prng.uniform(k, shape, tiny, 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= tiny and got.max() < 1.0


def test_uniform_of_folded_keys_matches_jax():
    """The draw a serving round makes: a [B, V] uniform under
    ``fold_in(PRNGKey(seed), step)``."""
    for seed, step in ((0, 0), (3, 17), (11, 4096), (-5, 123)):
        jk, k = _keys(seed)
        jk, k = jax.random.fold_in(jk, step), prng.fold_in(k, step)
        np.testing.assert_array_equal(
            prng.uniform(k, (8, 512)).numpy(),
            np.asarray(jax.random.uniform(jk, (8, 512))))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gumbel_within_tolerance(shape):
    worst = 0.0
    for seed in SEEDS:
        jk, k = _keys(seed)
        want = np.asarray(jax.random.gumbel(jk, shape))
        got = prng.gumbel(k, shape).numpy()
        assert np.isfinite(got).all()
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"gumbel {shape}: max |port - jax| = {worst:.3g}")
    assert worst <= GUMBEL_ATOL


@pytest.mark.parametrize("V", [7, 64, 1000])
def test_categorical_matches_jax(V):
    rng = np.random.default_rng(V)
    for seed in SEEDS:
        logits = (3.0 * rng.standard_normal((8, V))).astype(np.float32)
        jk, k = _keys(seed)
        want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
        got = prng.categorical(k, torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_never_draws_a_masked_logit():
    """Logits at the sampler's -1e30 mask lose to any finite one."""
    k = prng.prng_key(0)
    logits = torch.full((2, 6), -1e30)
    logits[:, 2] = 0.0
    assert prng.categorical(k, logits).tolist() == [2, 2]


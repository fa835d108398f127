"""The port's threefry keys and bit streams, its bits -> sample chains and
its XLA-exact f32 math, held bitwise against jax on the same keys."""
import random
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.utils.prng import fold_name as ref_fold_name
from repro.utils.prng import sample_direction as ref_sample_direction
from repro_torch.utils import prng, xla_math

pytestmark = pytest.mark.torch
# small tensors: torch's intra-op thread pool only adds overhead here, and
# the test workers already share the cores
torch.set_num_threads(1)

SEEDS = [0, 1, 42, 12345, 2 ** 31 - 1]
SHAPES = [(33, 7), (98, 128), (4097,), (1,), ()]


def _key_words(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def _bits_eq(a, b):
    """a: f32 numpy array, b: f32 torch tensor; bitwise."""
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  b.numpy().view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_fold_name(seed):
    k = jax.random.key(seed)
    assert _key_words(k) == prng.key(seed)
    assert [_key_words(x) for x in jax.random.split(k, 7)] == \
        prng.split(prng.key(seed), 7)
    for d in (0, 1, 2, 99, 2 ** 31 + 5, 2 ** 32 - 1):
        assert _key_words(jax.random.fold_in(k, d)) == \
            prng.fold_in(prng.key(seed), d)
    for name in ("dp_noise", "codec_hat", ""):
        assert _key_words(ref_fold_name(k, name)) == \
            prng.fold_name(prng.key(seed), name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_bitwise(seed, shape):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
    got = prng.bits(_key_words(k), shape, "cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(want, got.numpy().view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_and_rademacher_chains_bitwise(seed):
    k = jax.random.key(seed)
    b = prng.bits(prng.key(seed), (4097,), "cpu")
    _bits_eq(jax.random.uniform(k, (4097,)), prng.uniform_from_bits(b))
    _bits_eq(ref_sample_direction(k, (4097,), "rademacher"),
             prng.rademacher_from_bits(b))


@pytest.mark.parametrize("seed", [3, 11])
def test_normal_and_laplace_chains_bitwise(seed):
    """Bitwise, not within ulps: the port carries XLA's own erf_inv,
    log1p and log (1 << 16 draws reach every branch)."""
    n = 1 << 16
    k = jax.random.key(seed)
    b = prng.bits(prng.key(seed), (n,), "cpu")
    _bits_eq(jax.random.normal(k, (n,)), prng.normal_from_bits(b))
    _bits_eq(jax.random.laplace(k, (n,)), prng.laplace_from_bits(b))
    _bits_eq(ref_sample_direction(k, (n,), "gaussian"),
             prng.sample_direction(prng.key(seed), (n,), "gaussian", "cpu"))


def _uniform_inputs(lo, hi, n, seed):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


def test_erf_inv_bitwise():
    x = _uniform_inputs(-1, 1, 1 << 16, 0)
    x[:4] = [-1.0, 1.0, 0.0, np.float32(0.99999994)]
    _bits_eq(jax.jit(jax.lax.erf_inv)(x), xla_math.erf_inv(torch.from_numpy(x)))


@pytest.mark.parametrize("lo,hi", [(-0.4142, 0.4142), (-0.999, 4.0)])
def test_log1p_bitwise_both_branches(lo, hi):
    x = _uniform_inputs(lo, hi, 1 << 16, 1)
    _bits_eq(jax.jit(jax.lax.log1p)(x), xla_math.log1p(torch.from_numpy(x)))


def test_log_bitwise():
    x = np.concatenate([_uniform_inputs(1e-6, 4.0, 1 << 16, 2),
                        _uniform_inputs(4.0, 1e6, 1 << 16, 3),
                        np.float32([0.0, -0.0, 1.0, np.inf, 1e-40, -1e-40,
                                    -1.0, np.nan])])
    _bits_eq(jax.jit(jnp.log)(x), xla_math.log(torch.from_numpy(x)))


def _nearest_f32(exact: Fraction) -> np.float32:
    """Correctly rounded (ties to even) f32 of an exact rational."""
    r = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(r, np.float32(-np.inf)), r,
                 np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - exact)
        even = int(np.float32(cand).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return np.float32(best[1])


def test_fma32_is_one_correct_rounding():
    rng = random.Random(0)
    a, b, c = (np.float32([rng.uniform(-4, 4) for _ in range(400)])
               for _ in range(3))
    # hard cases: c cancels the product almost exactly
    c[:100] = -(a[:100] * b[:100])
    got = xla_math.fma32(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(c)).numpy()
    want = np.float32([_nearest_f32(Fraction(float(x)) * Fraction(float(y))
                                    + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sqrt_rn_is_correctly_rounded():
    x = _uniform_inputs(0.0, 100.0, 1 << 16, 4)
    np.testing.assert_array_equal(
        xla_math.sqrt_rn(torch.from_numpy(x)).numpy().view(np.int32),
        np.sqrt(x).view(np.int32))

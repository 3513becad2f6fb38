"""RNG tests: statistical correctness of the counter-based streams.

Contract: src/core/shared/pcg_shared.h (hash/uniform/gaussian/get_dist,
feistel_bijection). We verify hash value parity against the published PCG
constants, distribution moments, and the bijection property.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.config.schema import DistType
from ice_halo_sim_jax.core import rng


def _pcg_hash_ref(x):
    """Reference scalar implementation (pcg_shared.h:192-196)."""
    x = (x * 747796405 + 2891336453) & 0xFFFFFFFF
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & 0xFFFFFFFF
    return ((x >> 22) ^ x) & 0xFFFFFFFF


def test_pcg_hash_parity():
    xs = np.array([0, 1, 2, 12345, 0xDEADBEEF, 0xFFFFFFFF], dtype=np.uint32)
    got = np.asarray(rng.pcg_hash(jnp.asarray(xs)))
    want = np.array([_pcg_hash_ref(int(x)) for x in xs], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_uniform_range_and_independence():
    idx = jnp.arange(100000, dtype=jnp.uint32)
    u = np.asarray(rng.uniform(7, idx, 0))
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
    # Different slots give decorrelated draws.
    u2 = np.asarray(rng.uniform(7, idx, 1))
    assert abs(np.corrcoef(u, u2)[0, 1]) < 0.02
    # Different seeds give decorrelated draws.
    u3 = np.asarray(rng.uniform(8, idx, 0))
    assert abs(np.corrcoef(u, u3)[0, 1]) < 0.02


def test_gaussian_moments():
    idx = jnp.arange(200000, dtype=jnp.uint32)
    g = np.asarray(rng.gaussian(3, idx, 0))
    assert abs(g.mean()) < 0.01
    assert abs(g.std() - 1.0) < 0.01


@pytest.mark.parametrize(
    "dtype,center,spread,check",
    [
        (DistType.NO_RANDOM, 5.0, 2.0, lambda x: np.allclose(x, 5.0)),
        (DistType.UNIFORM, 10.0, 4.0, lambda x: x.min() >= 8.0 and x.max() <= 12.0
         and abs(x.mean() - 10.0) < 0.05),
        (DistType.GAUSS, 2.0, 3.0, lambda x: abs(x.mean() - 2.0) < 0.05 and abs(x.std() - 3.0) < 0.05),
        (DistType.ZIGZAG, 0.0, 1.0, lambda x: x.min() >= 0.0 and x.max() <= 1.0),
        (DistType.LAPLACIAN, 1.0, 0.5, lambda x: abs(np.median(x) - 1.0) < 0.02
         and abs(x.std() - 0.5 * np.sqrt(2)) < 0.05),
    ],
)
def test_sample_dist(dtype, center, spread, check):
    idx = jnp.arange(100000, dtype=jnp.uint32)
    x = np.asarray(rng.sample_dist(11, idx, 0, int(dtype), center, spread))
    assert check(x), f"{dtype}: mean={x.mean()} std={x.std()} min={x.min()} max={x.max()}"


def test_uniform_spread_is_full_range():
    """kUniform spread is the FULL range, not half (math.hpp:152)."""
    idx = jnp.arange(50000, dtype=jnp.uint32)
    x = np.asarray(rng.sample_dist(1, idx, 0, int(DistType.UNIFORM), 0.0, 360.0))
    assert x.min() >= -180.0 and x.max() <= 180.0
    assert x.max() > 170.0 and x.min() < -170.0


@pytest.mark.parametrize("n", [2, 3, 5, 7, 16, 100, 1000, 4097])
def test_feistel_is_bijection(n):
    i = jnp.arange(n, dtype=jnp.uint32)
    out = np.asarray(rng.feistel_bijection(i, n, 42))
    assert sorted(out.tolist()) == list(range(n))
    if n > 4:
        # Different seed gives a different permutation (n=2 is seed-independent).
        out2 = np.asarray(rng.feistel_bijection(i, n, 43))
        assert not np.array_equal(out, out2)


def test_hi_epoch_seed_identity_below_2_32():
    assert int(rng.hi_epoch_seed(12345, 0)) == 12345
    assert int(rng.hi_epoch_seed(12345, 1)) != 12345


def test_mul_u32_split_exact():
    import jax.numpy as jnp

    cases = [(0, 7), (1, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
             (123456789, 2654435761), (0x87654321, 1 << 19),
             (3141592653, 999999937)]
    for c, s in cases:
        lo, hi = rng.mul_u32_split(jnp.uint32(c), s)
        full = (c * s) & 0xFFFFFFFFFFFFFFFF
        assert int(lo) == (full & 0xFFFFFFFF), (c, s)
        assert int(hi) == (full >> 32), (c, s)


def test_epoch_seed_carry_detect():
    import jax.numpy as jnp

    base_lo = jnp.uint32(0xFFFFFF00)
    idx = base_lo + jnp.arange(512, dtype=jnp.uint32)  # wraps at offset 256
    s = rng.epoch_seed(7, base_lo, jnp.uint32(0), idx)
    s_np = np.asarray(s)
    # Pre-wrap: hi == 0 -> identity.
    assert (s_np[:256] == 7).all()
    # Post-wrap: hi == 1 -> mixed, uniform within the epoch.
    assert (s_np[256:] != 7).all()
    assert len(set(s_np[256:].tolist())) == 1

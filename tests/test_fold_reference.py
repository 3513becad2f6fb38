"""The XLA scatter-add fold against a float64 np.add.at reference.

The scatter fold is the default fold (core/accum.AUTO_METHOD). On a GPU its
float32 atomics add in an order that varies from run to run, so the check
is a per-pixel worst-case bound on float32 summation in any order
(chip_smoke.scatter_vs_add_at); the same function runs on the card in
chip_smoke.py. The cases cover spread and hot-pixel row distributions at a
small image and at the reference's 512x256 bench resolution.
"""

import numpy as np
import pytest

import chip_smoke
from ice_halo_sim_jax.core import accum


def _rows(n_pixels, n_rows, skew, seed):
    rng = np.random.default_rng(seed)
    if skew == "uniform":
        pix = rng.integers(0, n_pixels, n_rows)
    elif skew == "zipf":
        pix = np.minimum(rng.zipf(1.3, n_rows) - 1, n_pixels - 1)
    else:  # one pixel takes half the rows, like the sun's disk
        pix = rng.integers(0, n_pixels, n_rows)
        pix[rng.random(n_rows) < 0.5] = n_pixels // 3
    pix = pix.astype(np.int32)
    pix[rng.random(n_rows) < 0.05] = -1        # dead rows
    vals = rng.uniform(0.0, 1.0, (n_rows, 3)).astype(np.float32)
    vals[rng.random(n_rows) < 0.1] *= 1e-4     # emit-floor-sized rows
    return pix, vals


@pytest.mark.parametrize("skew", ["uniform", "zipf", "hot_pixel"])
@pytest.mark.parametrize("n_pixels", [64 * 32, 512 * 256])
def test_scatter_fold_matches_float64_add_at(n_pixels, skew):
    pix, vals = _rows(n_pixels, 200_000, skew, seed=n_pixels % 97)
    rep = chip_smoke.scatter_vs_add_at(pix, vals, n_pixels)
    assert rep["rows"] == int((pix >= 0).sum())
    if skew == "hot_pixel":
        assert rep["max_rows_per_pixel"] > 90_000
    assert rep["mass_rel_err"] < 1e-5


def test_scatter_bound_catches_a_lost_row():
    """The bound is tight enough that one dropped row fails the check."""
    pix, vals = _rows(1024, 50_000, "uniform", seed=3)
    vals[:, :] = np.maximum(vals, 0.5)
    lost = pix.copy()
    first = int(np.flatnonzero(pix >= 0)[0])
    lost[first] = -1

    import jax.numpy as jnp

    good = np.asarray(accum.scatter_accumulate(
        jnp.zeros((1024, 3)), jnp.asarray(lost), jnp.asarray(vals)), np.float64)
    ref = np.zeros((1024, 3))
    ok = pix >= 0
    np.add.at(ref, pix[ok], vals[ok].astype(np.float64))
    n = np.bincount(pix[ok], minlength=1024)[:, None]
    assert (np.abs(good - ref) > (n + 1) * chip_smoke.U32 * ref).any()


def test_auto_resolves_to_the_measured_fold():
    import jax.numpy as jnp

    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine
    from tests.test_e2e import SMOKE_CFG

    pix, vals = _rows(256, 4096, "zipf", seed=5)
    acc = jnp.zeros((256, 3))
    auto = accum.accumulate(acc, jnp.asarray(pix), jnp.asarray(vals))
    pinned = accum.accumulate(acc, jnp.asarray(pix), jnp.asarray(vals),
                              method=accum.AUTO_METHOD)
    np.testing.assert_array_equal(np.asarray(auto), np.asarray(pinned))
    eng = Engine(load_project(SMOKE_CFG), seed=1, batch_size=1 << 12)
    assert eng.fold_kind == accum.AUTO_METHOD

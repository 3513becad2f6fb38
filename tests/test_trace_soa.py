"""SoA trace kernel parity vs the AoS reference formulation.

trace_soa.trace_layer_soa must reproduce trace.trace_layer exactly (same
RNG streams, same math, different array layout): exits match slot-for-slot
after transposition, for both the shared-geometry (K == 1) path and the
per-setting blocked pool path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ice_halo_sim_jax.core import geometry, optics, rng, sampling, trace, trace_soa


def _pool_single(h=1.1, dists=None):
    d = jnp.asarray(dists if dists is not None else [1.0] * 6, jnp.float32)
    g = geometry.prism_geom_batch(jnp.asarray([h]), d[None, :])
    tris = jax.vmap(sampling.build_entry_tris)(g)
    return trace.make_geom_pool(g, tris)


def _pool_multi(k):
    hs = jnp.linspace(0.4, 1.6, k)
    ds = jnp.stack([jnp.linspace(0.8, 1.2, 6) for _ in range(k)])
    g = geometry.prism_geom_batch(hs, ds)
    tris = jax.vmap(sampling.build_entry_tris)(g)
    return trace.make_geom_pool(g, tris)


def _run_pair(pool, setting_blocks, B=256, max_hits=6, seed=11):
    idx = jnp.arange(B, dtype=jnp.uint32)
    d_world = sampling.sample_sun_dirs(jnp.uint32(99), idx, 0.0, 25.0, 0.5)
    w0 = jnp.full((B,), 1.0, jnp.float32)
    lon = rng.uniform(jnp.uint32(1), idx, 0) * 6.28
    lat = rng.uniform(jnp.uint32(2), idx, 0) * 3.0 - 1.5
    roll = rng.uniform(jnp.uint32(3), idx, 0) * 6.28
    rot = sampling.build_rotation(lon, lat, roll)
    n_ior = jnp.full((B,), 1.31, jnp.float32)

    aos = trace.trace_layer(
        seed, idx, d_world, w0, rot, None, pool, n_ior, max_hits,
        setting_blocks=setting_blocks,
    )
    soa = trace_soa.trace_layer_soa(
        seed, idx,
        (d_world[:, 0], d_world[:, 1], d_world[:, 2]),
        w0, trace_soa.rot_components(lon, lat, roll), pool, n_ior, max_hits,
        setting_blocks=setting_blocks,
    )
    return aos, soa


def _assert_match(aos, soa, tol=2e-5):
    np.testing.assert_array_equal(np.asarray(soa.entry_ok), np.asarray(aos.entry_ok))
    w_aos = np.asarray(aos.w)                 # [B, H]
    w_soa = np.asarray(soa.w).T               # [H, B] -> [B, H]
    np.testing.assert_allclose(w_soa, w_aos, rtol=tol, atol=tol)
    np.testing.assert_array_equal(np.asarray(soa.path).T, np.asarray(aos.path))
    d_aos = np.asarray(aos.d_world)           # [B, H, 3]
    live = w_aos > 0
    for c, comp in enumerate((soa.dx, soa.dy, soa.dz)):
        np.testing.assert_allclose(
            np.asarray(comp).T[live], d_aos[..., c][live], rtol=tol, atol=tol
        )


def test_soa_matches_aos_shared_geometry():
    pool = _pool_single()
    aos, soa = _run_pair(pool, setting_blocks=((1, 256),))
    _assert_match(aos, soa)
    assert float(jnp.sum(soa.w)) > 0.1  # nontrivial scene


def test_soa_matches_aos_blocked_pool():
    pool = _pool_multi(8)
    # one setting with 8 pool shapes over 256 lanes (geom-clock blocks of 32)
    aos, soa = _run_pair(pool, setting_blocks=((8, 256),))
    _assert_match(aos, soa)


def test_soa_matches_aos_multi_setting():
    k1, k2 = 3, 5
    pool1 = _pool_multi(k1)
    pool2 = _pool_multi(k2)
    pool = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), pool1, pool2)
    aos, soa = _run_pair(pool, setting_blocks=((k1, 96), (k2, 160)))
    _assert_match(aos, soa)


def test_energy_conservation_soa():
    pool = _pool_single()
    _, soa = _run_pair(pool, setting_blocks=((1, 256),), max_hits=24)
    # With enough bounces, emitted weight approaches the input weight.
    total_out = float(jnp.sum(soa.w))
    assert total_out <= 256.0 + 1e-3
    assert total_out > 0.95 * 256.0

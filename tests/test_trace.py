"""Trace-kernel tests: energy conservation and physical halo anchors.

The 22-degree minimum-deviation anchor is the golden-analytic core of the
whole simulator: alternating side faces of a hexagonal prism form a 60-degree
prism, whose minimum deviation delta_min = 2 asin(n sin 30) - 60 deg. Any
correct tracer must show a deviation distribution that starts exactly there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.core import geometry as geo
from ice_halo_sim_jax.core import optics, sampling, trace


def make_pool(h=1.0, dist=None):
    d = jnp.asarray(dist if dist is not None else [1.0] * 6, jnp.float32)
    g = geo.prism_geom(jnp.float32(h), d)
    g_b = jax.tree.map(lambda a: a[None], g)
    tris = sampling.build_entry_tris(g)
    tris_b = jax.tree.map(lambda a: a[None], tris)
    return trace.make_geom_pool(geo.CrystalGeom(*g_b), sampling.EntryTris(*tris_b))


def run_trace(n, d_world, rot, max_hits=8, seed=7, n_ior=1.31, h=1.0):
    pool = make_pool(h=h)
    idx = jnp.arange(n, dtype=jnp.uint32)
    return trace.trace_layer(
        seed, idx, d_world, jnp.ones(n), rot, jnp.zeros(n, jnp.int32), pool,
        jnp.full(n, n_ior, jnp.float32), max_hits,
    )


def random_rotations(n, seed=3):
    rs = np.random.default_rng(seed)
    lon = jnp.asarray(rs.uniform(0, 2 * np.pi, n), jnp.float32)
    lat = jnp.asarray(np.arcsin(rs.uniform(-1, 1, n)), jnp.float32)
    roll = jnp.asarray(rs.uniform(0, 2 * np.pi, n), jnp.float32)
    return sampling.build_rotation(lon, lat, roll)


def test_energy_conservation():
    """Total emitted weight approaches the input weight as max_hits grows
    (the residue is the weight still bouncing when the loop ends)."""
    n = 4000
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (n, 1))
    rot = random_rotations(n)
    exits = run_trace(n, d, rot, max_hits=24)
    total = np.asarray(trace.total_exit_weight(exits))
    ok = np.asarray(exits.entry_ok)
    assert ok.all()
    assert (total <= 1.0 + 1e-5).all()
    # With 24 interactions nearly all energy has escaped (TIR chains decay).
    assert total.mean() > 0.98
    # Short trace keeps strictly less.
    exits_short = run_trace(n, d, rot, max_hits=3)
    total_short = np.asarray(trace.total_exit_weight(exits_short))
    assert (total_short <= total + 1e-5).all()


def test_normal_incidence_plate():
    """Plate crystal (c-axis up), sun directly overhead: entry at the top
    basal face (fn 1), straight-through exit at the bottom (fn 2), external
    reflection weight = Fresnel normal-incidence R."""
    n = 64
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (n, 1))
    rot = jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (n, 1, 1))
    n_ior = 1.31
    exits = run_trace(n, d, rot, max_hits=8, n_ior=n_ior)
    path = np.asarray(exits.path)
    w = np.asarray(exits.w)
    d_out = np.asarray(exits.d_world)
    r0 = ((n_ior - 1) / (n_ior + 1)) ** 2
    # Slot 0: external reflection straight back up with weight R.
    np.testing.assert_allclose(w[:, 0], r0, rtol=1e-5)
    assert np.allclose(d_out[:, 0], np.array([0, 0, 1.0]), atol=1e-5)
    # Path: entry basal fn 1, then bottom basal fn 2.
    assert (path[:, 0] == 1).all()
    assert (path[:, 1] == 2).all()
    # Slot 1: transmitted straight down, weight (1-R)^2.
    np.testing.assert_allclose(w[:, 1], (1 - r0) ** 2, rtol=1e-4)
    assert np.allclose(d_out[:, 1], np.array([0, 0, -1.0]), atol=1e-5)
    # Slot 2: internal double reflection exits back up through fn 1.
    np.testing.assert_allclose(w[:, 2], (1 - r0) ** 2 * r0, rtol=1e-3)
    assert np.allclose(d_out[:, 2], np.array([0, 0, 1.0]), atol=1e-5)
    assert (path[:, 2] == 1).all()


def test_22_degree_minimum_deviation():
    """Exits whose 2-face path crosses alternating side faces (a 60-degree
    prism) deviate by at least delta_min = 2 asin(n sin 30) - 60, with the
    distribution peaking just above it (the 22-degree halo)."""
    n = 200000
    n_ior = 1.31
    d_in = np.array([0.0, 0.0, -1.0], np.float32)
    d = jnp.tile(jnp.asarray(d_in)[None], (n, 1))
    rot = random_rotations(n, seed=11)
    exits = run_trace(n, d, rot, max_hits=4, n_ior=n_ior, h=1.0)

    w = np.asarray(exits.w)
    plen = np.asarray(exits.path_len)
    path = np.asarray(exits.path)
    d_out = np.asarray(exits.d_world)

    # Length-2 paths through side faces with |pri difference| == 2 (mod 6).
    sel_slot = 1  # first internal bounce exit has path length 2
    f_in, f_out = path[:, 0], path[:, 1]
    side = (f_in >= 3) & (f_out >= 3)
    dpri = (f_in - f_out) % 6
    prism60 = side & ((dpri == 2) | (dpri == 4)) & (plen[:, sel_slot] == 2) & (w[:, sel_slot] > 1e-4)
    assert prism60.sum() > 1000

    cosang = np.clip(d_out[prism60, sel_slot, :] @ d_in, -1, 1)
    dev = np.degrees(np.arccos(cosang))
    delta_min = np.degrees(2 * np.arcsin(n_ior * 0.5)) - 60.0
    # No weight below the minimum deviation (within sampling tolerance).
    w_sel = w[prism60, sel_slot]
    below = w_sel[dev < delta_min - 0.3].sum()
    assert below < 1e-3 * w_sel.sum()
    # Density concentrates near delta_min: the [dmin, dmin+2deg] band carries
    # far more weight per degree than [dmin+8, dmin+10].
    band1 = w_sel[(dev >= delta_min) & (dev < delta_min + 2)].sum()
    band2 = w_sel[(dev >= delta_min + 8) & (dev < delta_min + 10)].sum()
    assert band1 > 3 * band2


def test_basal_90deg_prism_anchor():
    """Side-to-basal paths form a 90-degree prism: delta_min = 2 asin(n sin 45)
    - 90 ~ 46 degrees (the 46-degree halo). Verify no weight below it."""
    n = 200000
    n_ior = 1.31
    d_in = np.array([0.0, 0.0, -1.0], np.float32)
    d = jnp.tile(jnp.asarray(d_in)[None], (n, 1))
    rot = random_rotations(n, seed=13)
    exits = run_trace(n, d, rot, max_hits=4, n_ior=n_ior)
    w = np.asarray(exits.w)
    plen = np.asarray(exits.path_len)
    path = np.asarray(exits.path)
    d_out = np.asarray(exits.d_world)
    f_in, f_out = path[:, 0], path[:, 1]
    side_basal = ((f_in >= 3) & (f_out <= 2)) | ((f_in <= 2) & (f_out >= 3))
    sel = side_basal & (plen[:, 1] == 2) & (w[:, 1] > 1e-4)
    assert sel.sum() > 500
    cosang = np.clip(d_out[sel, 1, :] @ d_in, -1, 1)
    dev = np.degrees(np.arccos(cosang))
    delta_min = np.degrees(2 * np.arcsin(n_ior * np.sin(np.deg2rad(45)))) - 90.0
    w_sel = w[sel, 1]
    below = w_sel[dev < delta_min - 0.5].sum()
    assert below < 1e-3 * w_sel.sum()


def test_dead_lane_zero_weight():
    """Lanes that miss every crystal (empty pool geometry) emit nothing."""
    g = geo.prism_geom(jnp.float32(0.0), jnp.ones(6, jnp.float32))
    g_b = jax.tree.map(lambda a: a[None], g)
    tris = jax.tree.map(lambda a: a[None], sampling.build_entry_tris(g))
    pool = trace.make_geom_pool(geo.CrystalGeom(*g_b), sampling.EntryTris(*tris))
    n = 32
    exits = trace.trace_layer(
        1, jnp.arange(n, dtype=jnp.uint32),
        jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (n, 1)),
        jnp.ones(n), jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (n, 1, 1)),
        jnp.zeros(n, jnp.int32), pool, jnp.full(n, 1.31), 6,
    )
    assert not bool(np.any(np.asarray(exits.entry_ok)))
    assert float(jnp.sum(exits.w)) == 0.0


def test_trace_is_jittable_and_deterministic():
    n = 256
    d = jnp.tile(jnp.asarray([[0.6, 0.0, -0.8]], jnp.float32), (n, 1))
    rot = random_rotations(n, seed=5)
    pool = make_pool()
    idx = jnp.arange(n, dtype=jnp.uint32)
    f = jax.jit(trace.trace_layer, static_argnames=("max_hits",))
    e1 = f(3, idx, d, jnp.ones(n), rot, jnp.zeros(n, jnp.int32), pool, jnp.full(n, 1.31), 6)
    e2 = f(3, idx, d, jnp.ones(n), rot, jnp.zeros(n, jnp.int32), pool, jnp.full(n, 1.31), 6)
    np.testing.assert_array_equal(np.asarray(e1.w), np.asarray(e2.w))
    np.testing.assert_array_equal(np.asarray(e1.path), np.asarray(e2.path))

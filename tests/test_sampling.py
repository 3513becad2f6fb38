"""Sampling tests: sun cone, rotations, orientation distributions, entry faces.

Oracles: closed-form cone geometry, rotation-matrix algebra (orthonormality,
axis mapping), area-measure latitude density sin-weighting, and the
projected-area entry-face law on a hand-computable prism.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.config.schema import AxisDistribution, DistType, Distribution
from ice_halo_sim_jax.core import geometry as geo
from ice_halo_sim_jax.core import sampling as smp
from ice_halo_sim_jax.core.latlut import build_lat_lut


def test_sun_cap_geometry():
    """All directions within diameter/2 of the cap center; mean direction is
    the center; distribution covers the cap."""
    n = 20000
    idx = jnp.arange(n, dtype=jnp.uint32)
    alt, az, diam = 25.0, 40.0, 0.5
    d = np.asarray(smp.sample_sun_dirs(3, idx, az, alt, diam))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    # Cap center: direction of travel = (cos(az+180)cos(-alt), sin(az+180)cos(-alt), sin(-alt)).
    lon = np.deg2rad(az + 180)
    lat = np.deg2rad(-alt)
    center = np.array([np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat), np.sin(lat)])
    cosang = d @ center
    assert cosang.min() >= np.cos(np.deg2rad(diam / 2)) - 1e-6
    # Sunlight heads downward for positive altitude.
    assert (d[:, 2] < 0).all()


def test_rotation_orthonormal_and_convention():
    """R is orthonormal; for lon=pi, lat=pi/2, roll=0 it is the identity
    (BuildCrystalRotation: Rz(lon-pi) Ry(lat-pi/2) Rz(roll))."""
    r = np.asarray(smp.build_rotation(jnp.float32(np.pi), jnp.float32(np.pi / 2), jnp.float32(0.0)))
    np.testing.assert_allclose(r, np.eye(3), atol=1e-6)

    lon, lat, roll = 0.7, 0.3, 1.9
    r = np.asarray(smp.build_rotation(jnp.float32(lon), jnp.float32(lat), jnp.float32(roll)))
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    # The crystal c-axis (0,0,1) maps to the sampled (lon, lat) direction:
    # z_world = R @ z_crystal = (cos lon cos lat... ) — check against spherical.
    z_w = r @ np.array([0.0, 0.0, 1.0])
    expect = np.array([np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat), np.sin(lat)])
    np.testing.assert_allclose(z_w, expect, atol=1e-5)


def test_rotate_inverse_roundtrip():
    n = 100
    rs = np.random.default_rng(0)
    lon = jnp.asarray(rs.uniform(0, 2 * np.pi, n), jnp.float32)
    lat = jnp.asarray(rs.uniform(-np.pi / 2, np.pi / 2, n), jnp.float32)
    roll = jnp.asarray(rs.uniform(0, 2 * np.pi, n), jnp.float32)
    rot = smp.build_rotation(lon, lat, roll)
    v = jnp.asarray(rs.normal(size=(n, 3)), jnp.float32)
    back = smp.rotate(rot, smp.rotate_inv(rot, v))
    np.testing.assert_allclose(np.asarray(back), np.asarray(v), atol=1e-4)


def _axis_params_for(axis: AxisDistribution) -> smp.AxisParams:
    return smp.make_axis_params([axis], [build_lat_lut(axis.latitude)])


def test_full_sphere_uniform_z():
    """Full-sphere axis: world-z of the c-axis is uniform in [-1, 1]."""
    axis = AxisDistribution(
        azimuth=Distribution(DistType.UNIFORM, 0.0, 360.0),
        latitude=Distribution(DistType.UNIFORM, 90.0, 360.0),
        roll=Distribution(DistType.UNIFORM, 0.0, 360.0),
    )
    params = _axis_params_for(axis)
    n = 50000
    idx = jnp.arange(n, dtype=jnp.uint32)
    lon, lat, roll = smp.sample_lat_lon_roll(5, idx, params, jnp.zeros(n, jnp.int32))
    z = np.sin(np.asarray(lat))
    assert abs(z.mean()) < 0.01
    hist, _ = np.histogram(z, bins=10, range=(-1, 1))
    assert hist.min() > 0.9 * n / 10 * 0.9


def test_gauss_latitude_area_measure():
    """zenith ~ gauss(0, sigma): sampled colatitude density follows
    sin(theta)-weighted gaussian — the area-measure correction
    (doc/near-pole-area-measure-sampling.md). Check the mode is pushed off the
    pole: E[theta] for sin-weighted half-gaussian > plain half-gaussian."""
    sigma = 2.0
    axis = AxisDistribution(
        azimuth=Distribution(DistType.UNIFORM, 0.0, 360.0),
        latitude=Distribution(DistType.GAUSS, 90.0, sigma),
        roll=Distribution(DistType.UNIFORM, 0.0, 360.0),
    )
    params = _axis_params_for(axis)
    n = 100000
    idx = jnp.arange(n, dtype=jnp.uint32)
    lon, lat, roll = smp.sample_lat_lon_roll(9, idx, params, jnp.zeros(n, jnp.int32))
    theta = np.pi / 2 - np.asarray(lat)  # colatitude, ~ |N(0, sigma)| sin-weighted
    theta_deg = np.rad2deg(theta)
    # Analytic: density ~ sin(t) exp(-t^2 / 2 s^2) ~ t exp(-t^2/2s^2) (small t)
    # => Rayleigh(sigma); E = sigma sqrt(pi/2).
    expect_mean = sigma * np.sqrt(np.pi / 2)
    assert theta_deg.mean() == pytest.approx(expect_mean, rel=0.05)


def test_no_random_latitude():
    axis = AxisDistribution(
        azimuth=Distribution(DistType.UNIFORM, 0.0, 360.0),
        latitude=Distribution(DistType.NO_RANDOM, 90.0, 0.0),
        roll=Distribution(DistType.UNIFORM, 0.0, 360.0),
    )
    params = _axis_params_for(axis)
    idx = jnp.arange(100, dtype=jnp.uint32)
    _, lat, _ = smp.sample_lat_lon_roll(1, idx, params, jnp.zeros(100, jnp.int32))
    np.testing.assert_allclose(np.asarray(lat), np.pi / 2, atol=1e-6)


def test_entry_sampling_projected_area():
    """Rays heading straight down onto a regular prism must always enter the
    top basal face (slot 0); rays along -x enter side slot 2; oblique rays
    split between faces by projected area."""
    g = geo.prism_geom(jnp.float32(1.0), jnp.ones(6, jnp.float32))
    tris = smp.build_entry_tris(g)
    n = 20000
    idx = jnp.arange(n, dtype=jnp.uint32)

    def gather(tris, n):
        return smp.EntryTris(*[jnp.broadcast_to(a, (n,) + a.shape) for a in tris])

    bt = gather(tris, n)
    d_down = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (n, 1))
    p, face, ok, _ = smp.sample_entry(2, idx, d_down, bt)
    assert bool(np.all(np.asarray(ok)))
    assert (np.asarray(face) == 0).all()
    pn = np.asarray(p)
    np.testing.assert_allclose(pn[:, 2], 0.5, atol=1e-5)  # on the top plane
    # Points cover the hexagon uniformly: centroid near 0.
    assert abs(pn[:, 0].mean()) < 0.01 and abs(pn[:, 1].mean()) < 0.01

    # A lateral ray sees three side faces: slot 2 head-on (cos 1) and slots
    # 3, 7 at 60 degrees (cos 1/2) -> fractions 1/2, 1/4, 1/4.
    d_mx = jnp.tile(jnp.asarray([[-1.0, 0.0, 0.0]], jnp.float32), (n, 1))
    p, face, ok, _ = smp.sample_entry(2, idx, d_mx, bt)
    faces_mx = np.asarray(face)
    assert set(np.unique(faces_mx)) == {2, 3, 7}
    assert (faces_mx == 2).mean() == pytest.approx(0.5, abs=0.02)
    assert (faces_mx == 3).mean() == pytest.approx(0.25, abs=0.02)

    # 45-degree ray in the x-z plane: projected areas = A_top*cos + A_side0*cos
    # (+ two oblique sides at 60 deg).
    d_ob = jnp.tile(jnp.asarray([[-np.sin(np.deg2rad(45.0)), 0.0, -np.cos(np.deg2rad(45.0))]],
                                dtype=jnp.float32), (n, 1))
    p, face, ok, _ = smp.sample_entry(2, idx, d_ob, bt)
    faces = np.asarray(face)
    hex_area = 3 * np.sqrt(3) / 2 * 0.25
    s = np.sin(np.deg2rad(45.0))
    c = np.cos(np.deg2rad(45.0))
    w_top = hex_area * c
    w_side0 = 0.5 * s  # rectangle area 0.5*1, full projection
    w_side_adj = 0.5 * s * 0.5  # sides 1 & 5 at 60 deg: cos(60)=0.5
    total = w_top + w_side0 + 2 * w_side_adj
    frac_top = (faces == 0).mean()
    assert frac_top == pytest.approx(w_top / total, abs=0.02)
    frac_s0 = (faces == 2 + 0).mean()
    assert frac_s0 == pytest.approx(w_side0 / total, abs=0.02)


def test_entry_sampling_empty_crystal():
    g = geo.prism_geom(jnp.float32(0.0), jnp.ones(6, jnp.float32))
    tris = smp.build_entry_tris(g)
    n = 16
    bt = smp.EntryTris(*[jnp.broadcast_to(a, (n,) + a.shape) for a in tris])
    idx = jnp.arange(n, dtype=jnp.uint32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (n, 1))
    _, _, ok, _ = smp.sample_entry(0, idx, d, bt)
    assert not bool(np.any(np.asarray(ok)))

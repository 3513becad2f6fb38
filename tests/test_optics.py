"""Optics tests: IOR anchor values, Fresnel physics invariants, slab traversal.

Oracles: published ice IOR values, energy conservation R + T = 1, normal-
incidence Fresnel closed form, Snell's law on refracted directions, TIR
critical angle, and slab traversal on a hand-checked hexagonal prism.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.core import geometry as geo
from ice_halo_sim_jax.core import optics


def test_ice_ior_anchors():
    # Ice refractive index ~1.31 in the visible; decreasing with wavelength.
    n = np.asarray(optics.ice_refractive_index(jnp.asarray([400.0, 550.0, 700.0])))
    assert 1.30 < n[1] < 1.32
    assert n[0] > n[1] > n[2]  # normal dispersion
    # Outside range -> 1.0 (reference contract).
    assert float(optics.ice_refractive_index(300.0)) == 1.0
    assert float(optics.ice_refractive_index(1000.0)) == 1.0


def test_fresnel_normal_incidence():
    """R at normal incidence = ((n-1)/(n+1))^2."""
    n_ior = 1.31
    d = jnp.asarray([[0.0, 0.0, -1.0]])      # heading into the face
    n_face = jnp.asarray([[0.0, 0.0, 1.0]])  # outward normal
    w = jnp.asarray([1.0])
    d_r, d_t, w_r, w_t, tir = optics.fresnel_split(d, n_face, w, n_ior)
    r_expect = ((n_ior - 1) / (n_ior + 1)) ** 2
    assert float(w_r[0]) == pytest.approx(r_expect, rel=1e-5)
    assert float(w_t[0]) == pytest.approx(1 - r_expect, rel=1e-5)
    assert not bool(tir[0])
    np.testing.assert_allclose(np.asarray(d_r[0]), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(d_t[0]), [0, 0, -1], atol=1e-6)


def test_fresnel_energy_conservation():
    """R + T = w for non-TIR at many angles, both entering and exiting."""
    n_ior = 1.31
    rng = np.random.default_rng(0)
    d = rng.normal(size=(1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n_face = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (1000, 1))
    w = np.ones(1000, np.float32)
    d_r, d_t, w_r, w_t, tir = optics.fresnel_split(jnp.asarray(d), jnp.asarray(n_face), jnp.asarray(w), n_ior)
    w_r, w_t, tir = np.asarray(w_r), np.asarray(w_t), np.asarray(tir)
    np.testing.assert_allclose(w_r + w_t, np.where(tir, w_r, 1.0), atol=1e-5)
    assert (w_r >= -1e-6).all() and (w_t >= -1e-6).all()


def test_snells_law():
    """Refracted direction satisfies n1 sin(theta1) = n2 sin(theta2)."""
    n_ior = 1.31
    theta1 = np.deg2rad(35.0)
    d = jnp.asarray([[np.sin(theta1), 0.0, -np.cos(theta1)]], dtype=jnp.float32)
    n_face = jnp.asarray([[0.0, 0.0, 1.0]])
    _, d_t, _, _, tir = optics.fresnel_split(d, n_face, jnp.ones(1), n_ior)
    assert not bool(tir[0])
    dt = np.array(d_t[0])
    dt = dt / np.linalg.norm(dt)
    sin_theta2 = np.hypot(dt[0], dt[1])
    assert sin_theta2 == pytest.approx(np.sin(theta1) / n_ior, rel=1e-5)


def test_tir_critical_angle():
    """Inside ice heading out: TIR iff sin(theta) > 1/n."""
    n_ior = 1.31
    crit = np.arcsin(1.0 / n_ior)
    for theta, expect_tir in [(crit - 0.01, False), (crit + 0.01, True)]:
        d = jnp.asarray([[np.sin(theta), 0.0, np.cos(theta)]], dtype=jnp.float32)
        n_face = jnp.asarray([[0.0, 0.0, 1.0]])
        d_r, _, w_r, w_t, tir = optics.fresnel_split(d, n_face, jnp.ones(1), n_ior)
        assert bool(tir[0]) == expect_tir, theta
        if expect_tir:
            assert float(w_r[0]) == pytest.approx(1.0)
            assert float(w_t[0]) == pytest.approx(0.0)


def test_slab_next_face_prism():
    """Hand-checked traversal on the regular prism (h=2): a ray at the origin
    heading +x exits side face 0 (x = sqrt(3)/4); heading +z exits the top."""
    g = geo.prism_geom(jnp.float32(2.0), jnp.ones(6, jnp.float32))
    p = jnp.zeros((2, 3))
    d = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    from_face = jnp.asarray([-1, -1], jnp.int32)
    nf = g.plane_n[None].repeat(2, axis=0)
    fd = g.plane_d[None].repeat(2, axis=0)
    fp = g.face_present[None].repeat(2, axis=0)
    t, idx, found = optics.slab_next_face(p, d, from_face, nf, fd, fp)
    assert bool(found[0]) and bool(found[1])
    assert int(idx[0]) == 2          # side slot for direction 0
    assert float(t[0]) == pytest.approx(geo.SQRT3_4, rel=1e-5)
    assert int(idx[1]) == 0          # upper basal
    assert float(t[1]) == pytest.approx(1.0, rel=1e-5)


def test_slab_excludes_source_face():
    """A ray starting ON the top face heading up must not re-select it; with
    no other candidate it reports found=False (outgoing)."""
    g = geo.prism_geom(jnp.float32(2.0), jnp.ones(6, jnp.float32))
    p = jnp.asarray([[0.0, 0.0, 1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, idx, found = optics.slab_next_face(
        p, d, jnp.asarray([0], jnp.int32), g.plane_n[None], g.plane_d[None], g.face_present[None]
    )
    assert not bool(found[0])


def test_slab_interior_always_finds_exit():
    """Random interior origins & directions always find an exit face, and the
    exit point lies on the hull boundary (convexity invariant)."""
    g = geo.prism_geom(jnp.float32(1.3), jnp.asarray([1.0, 0.9, 1.1, 1.0, 0.8, 1.2], jnp.float32))
    rng = np.random.default_rng(7)
    n = 500
    # Rejection-sample interior points in the bounding box.
    pts = []
    plane_n = np.asarray(g.plane_n)
    plane_d = np.asarray(g.plane_d)
    while len(pts) < n:
        c = rng.uniform(-0.7, 0.7, size=3).astype(np.float32)
        if (plane_n @ c + plane_d).max() < -1e-3:
            pts.append(c)
    p = np.stack(pts)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, idx, found = optics.slab_next_face(
        jnp.asarray(p), jnp.asarray(d), jnp.full((n,), -1, jnp.int32),
        jnp.tile(g.plane_n[None], (n, 1, 1)), jnp.tile(g.plane_d[None], (n, 1)),
        jnp.tile(g.face_present[None], (n, 1)),
    )
    assert bool(np.all(np.asarray(found)))
    hit = p + np.asarray(t)[:, None] * d
    slack = hit @ plane_n.T + plane_d
    # On the boundary: max slack ~ 0, never deep outside.
    assert slack.max() < 1e-3
    sel = np.asarray(idx)
    own = slack[np.arange(n), sel]
    np.testing.assert_allclose(own, 0.0, atol=1e-3)

"""Golden-analytic geometry tests.

Oracles are closed-form truths derived independently of the implementation
(the reference's golden-analytic strategy, doc/testing-architecture.md):
regular-hexagon areas, plane constants, face presence under face-distance
degeneracies, convexity/containment invariants.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.core import geometry as geo


def regular_prism(h=1.0):
    return geo.prism_geom(jnp.float32(h), jnp.ones(6, jnp.float32))


def test_regular_prism_planes():
    g = regular_prism(1.2)
    n = np.asarray(g.plane_n)
    d = np.asarray(g.plane_d)
    # Unit normals.
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-6)
    # Basal at z = +-0.6.
    assert d[0] == pytest.approx(-0.6)
    assert d[1] == pytest.approx(-0.6)
    # Sides at distance sqrt(3)/4.
    np.testing.assert_allclose(d[2:], -geo.SQRT3_4, atol=1e-6)
    # Face numbers.
    np.testing.assert_array_equal(np.asarray(g.face_number), [1, 2, 3, 4, 5, 6, 7, 8])
    assert bool(np.all(np.asarray(g.face_present)))


def test_regular_prism_areas():
    """Regular hexagon side a = 1/2 (circumradius): basal area = 3*sqrt(3)/8 * a^2 * ...
    With side planes at distance r = sqrt(3)/4, the hexagon has inradius r,
    side length s = 2r/sqrt(3) = 1/2, area = (3 sqrt(3)/2) s^2 = 3 sqrt(3)/8.
    Side rectangles: s x h."""
    h = 1.2
    g = regular_prism(h)
    areas = np.asarray(geo.polygon_areas(g))
    hex_area = 3.0 * np.sqrt(3.0) / 2.0 * 0.25
    assert areas[0] == pytest.approx(hex_area, rel=1e-5)
    assert areas[1] == pytest.approx(hex_area, rel=1e-5)
    np.testing.assert_allclose(areas[2:], 0.5 * h, rtol=1e-5)


def test_prism_vertices_on_planes():
    """Every polygon vertex lies on its own plane and inside all others."""
    g = geo.prism_geom(jnp.float32(0.9), jnp.asarray([1.0, 1.3, 0.8, 1.1, 0.9, 1.2], jnp.float32))
    n = np.asarray(g.plane_n)
    d = np.asarray(g.plane_d)
    vtx = np.asarray(g.face_vtx)
    cnt = np.asarray(g.face_vtx_cnt)
    present = np.asarray(g.face_present)
    for f in range(8):
        if not present[f]:
            continue
        for k in range(cnt[f]):
            v = vtx[f, k]
            # On own plane.
            assert abs(v @ n[f] + d[f]) < 1e-4, (f, k)
            # Inside every half-space.
            slack = v @ n.T + d
            assert slack.max() < 1e-4, (f, k, slack.max())


def test_prism_ccw_winding():
    """Fan-triangle normals of each present face point along the outward
    plane normal (the CCW-from-outside contract the entry sampler relies on,
    simulator.cpp:90-129)."""
    g = geo.prism_geom(jnp.float32(1.4), jnp.asarray([1.0, 0.9, 1.2, 1.0, 1.1, 0.7], jnp.float32))
    n = np.asarray(g.plane_n)
    vtx = np.asarray(g.face_vtx)
    cnt = np.asarray(g.face_vtx_cnt)
    present = np.asarray(g.face_present)
    for f in range(8):
        if not present[f]:
            continue
        v0 = vtx[f, 0]
        for k in range(1, cnt[f] - 1):
            tri_n = np.cross(vtx[f, k] - v0, vtx[f, k + 1] - v0)
            area2 = np.linalg.norm(tri_n)
            if area2 < 1e-9:
                continue
            assert tri_n @ n[f] > 0, (f, k)


def test_face_distance_drops_face():
    """A very large face distance removes that side face from the hull; the
    remaining cross-section is the intersection of the others."""
    dist = jnp.asarray([1.0, 1.0, 1.0, 1.0, 1.0, 10.0], jnp.float32)
    g = geo.prism_geom(jnp.float32(1.0), dist)
    present = np.asarray(g.face_present)
    assert not present[2 + 5]  # face 5 dropped
    assert present[:7].all()   # basal + other sides remain
    assert np.asarray(g.face_vtx_cnt)[2 + 5] == 0


def test_zero_height_degenerate():
    g = geo.prism_geom(jnp.float32(0.0), jnp.ones(6, jnp.float32))
    assert not bool(np.any(np.asarray(g.face_present)))


def test_empty_cross_section():
    """Strongly negative distances make the feasible region empty."""
    g = geo.prism_geom(jnp.float32(1.0), -2.0 * jnp.ones(6, jnp.float32))
    assert not bool(np.any(np.asarray(g.face_present)))


def test_triangle_cross_section():
    """Three faces pushed far out -> cross-section is a triangle; the pushed
    faces drop, basal polygons have 3 corners."""
    dist = jnp.asarray([1.0, 5.0, 1.0, 5.0, 1.0, 5.0], jnp.float32)
    g = geo.prism_geom(jnp.float32(1.0), dist)
    present = np.asarray(g.face_present)
    assert present[0] and present[1]
    np.testing.assert_array_equal(present[2:], [True, False, True, False, True, False])
    # Triangle area with three lines at inradius r: equilateral triangle with
    # inradius r has area 3 sqrt(3) r^2.
    areas = np.asarray(geo.polygon_areas(g))
    r = geo.SQRT3_4
    assert areas[0] == pytest.approx(3 * np.sqrt(3) * r * r, rel=1e-4)


def test_batched_construction():
    h = jnp.asarray([1.0, 0.5, 2.0], jnp.float32)
    dist = jnp.tile(jnp.ones((1, 6), jnp.float32), (3, 1))
    g = geo.prism_geom_batch(h, dist)
    assert g.plane_n.shape == (3, 8, 3)
    areas = np.asarray(jax.vmap(geo.polygon_areas)(g))
    np.testing.assert_allclose(areas[:, 2], 0.5 * np.asarray(h), rtol=1e-5)


def test_geometry_is_differentiable():
    """Basal area is differentiable w.r.t. face distances: for the regular
    hexagon d A / d (uniform scale s) at s=1 equals 2 * area."""

    def basal_area(s):
        g = geo.prism_geom(jnp.float32(1.0), s * jnp.ones(6, jnp.float32))
        return geo.polygon_areas(g)[0]

    grad = jax.grad(basal_area)(jnp.float32(1.0))
    hex_area = 3.0 * np.sqrt(3.0) / 2.0 * 0.25
    assert float(grad) == pytest.approx(2 * hex_area, rel=1e-3)

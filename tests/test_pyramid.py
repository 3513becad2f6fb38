"""Pyramid geometry tests.

Oracles: containment/on-plane invariants, analytic face counts and areas for
hand-computable configurations, degenerate degradations (apex collapse, no
prism segment, face-distance drops), and consistency with the prism when
both cones are absent.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.core import geometry as geo
from ice_halo_sim_jax.core import pyramid as pyr


def build(h1=0.3, h2=1.0, h3=0.3, au=28.0, al=28.0, dist=None):
    d = jnp.asarray(dist if dist is not None else [1.0] * 6, jnp.float32)
    return pyr.pyramid_geom(jnp.float32(h1), jnp.float32(h2), jnp.float32(h3), au, al, d)


def check_invariants(g, label=""):
    n = np.asarray(g.plane_n)
    d = np.asarray(g.plane_d)
    vtx = np.asarray(g.face_vtx)
    cnt = np.asarray(g.face_vtx_cnt)
    present = np.asarray(g.face_present)
    for f in range(20):
        if not present[f]:
            continue
        for k in range(cnt[f]):
            v = vtx[f, k]
            assert abs(v @ n[f] + d[f]) < 3e-4, (label, f, k, v @ n[f] + d[f])
            slack = v @ n.T + d
            assert slack.max() < 3e-4, (label, f, k, slack.max())


def test_regular_pyramid_all_faces():
    """Truncated pyramid with both cones: all 20 faces present."""
    g = build(h1=0.5, h2=1.0, h3=0.5)
    present = np.asarray(g.face_present)
    assert present.all(), present
    np.testing.assert_array_equal(
        np.asarray(g.face_number),
        [1, 2] + list(range(3, 9)) + list(range(13, 19)) + list(range(23, 29)),
    )
    check_invariants(g, "regular")
    # Cone faces are trapezoids (4 vertices); basal hexagons 6.
    cnt = np.asarray(g.face_vtx_cnt)
    assert cnt[0] == 6 and cnt[1] == 6
    assert (cnt[2:8] == 4).all()
    assert (cnt[8:] == 4).all()


def test_symmetry_of_regular_pyramid():
    """Six-fold symmetry: all prism faces share one area; all cone faces
    share another; upper/lower mirror (equal heights/angles)."""
    g = build(h1=0.4, h2=0.8, h3=0.4, au=30.0, al=30.0)
    areas = np.asarray(geo.polygon_areas(g))
    np.testing.assert_allclose(areas[2:8], areas[2], rtol=2e-3)
    np.testing.assert_allclose(areas[8:14], areas[8], rtol=2e-3)
    np.testing.assert_allclose(areas[14:20], areas[14], rtol=2e-3)
    np.testing.assert_allclose(areas[8:14], areas[14:20], rtol=2e-3)
    assert areas[0] == pytest.approx(areas[1], rel=2e-3)


def test_full_apex_collapse():
    """h1 = 1 with no prism/lower segment: a complete hexagonal cone — upper
    basal absent, lower basal present, no prism faces (h2 = 0)."""
    g = build(h1=1.0, h2=0.0, h3=0.0, au=45.0, al=0.0)  # al invalid -> no lower cone
    present = np.asarray(g.face_present)
    assert not present[0]            # apex: no upper basal
    assert present[1]                # flat base at z = 0
    assert not present[2:8].any()    # no prism segment
    assert present[8:14].all()       # six upper cone faces (triangles)
    assert not present[14:20].any()
    cnt = np.asarray(g.face_vtx_cnt)
    assert (cnt[8:14] == 3).all()
    check_invariants(g, "apex")
    # Apex height: z = a1 * m_apex = (sqrt3/4)/tan(45) * 1.0.
    vtx = np.asarray(g.face_vtx)
    z_max = vtx[np.asarray(g.face_present)].reshape(-1, 3)[:, 2].max()
    assert z_max == pytest.approx(geo.SQRT3_4, rel=1e-3)


def test_truncation_height():
    """z_top = h2/2 + a1 * h1 * m_apex for the regular hexagon (m_apex = 1)."""
    au = 35.0
    h1, h2 = 0.6, 0.9
    g = build(h1=h1, h2=h2, h3=0.2, au=au)
    a1 = geo.SQRT3_4 / np.tan(np.radians(au))
    z_top_expect = h2 / 2 + a1 * h1 * 1.0
    vtx = np.asarray(g.face_vtx)
    cnt = np.asarray(g.face_vtx_cnt)
    z_top = vtx[0, : cnt[0], 2]
    np.testing.assert_allclose(z_top, z_top_expect, rtol=1e-3)
    # Top basal hexagon side: inset shrinks distances to (1 - h1*m_apex).
    # Inradius at top = sqrt3/4 * (1 - 0.6) = 0.4 * sqrt3/4.
    r_top = np.hypot(vtx[0, : cnt[0], 0], vtx[0, : cnt[0], 1])
    # Circumradius of regular hexagon = inradius * 2/sqrt(3).
    expect_r = geo.SQRT3_4 * 0.4 * 2 / np.sqrt(3)
    np.testing.assert_allclose(r_top, expect_r, rtol=2e-3)


def test_no_cones_matches_prism():
    """Invalid wedge angles on both sides degrade to the plain prism."""
    g = build(h1=0.5, h2=1.2, h3=0.5, au=0.0, al=95.0)
    gp = geo.prism_geom(jnp.float32(1.2), jnp.ones(6, jnp.float32))
    present = np.asarray(g.face_present)
    assert present[:8].all() and not present[8:].any()
    areas = np.asarray(geo.polygon_areas(g))[:8]
    areas_p = np.asarray(geo.polygon_areas(gp))[:8]
    np.testing.assert_allclose(areas, areas_p, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(g.plane_d)[:8], np.asarray(gp.plane_d), atol=1e-5)


def test_face_distance_drop_on_pyramid():
    dist = [1.0, 1.0, 1.0, 1.0, 1.0, 8.0]
    g = build(h1=0.3, h2=1.0, h3=0.3, dist=dist)
    present = np.asarray(g.face_present)
    assert not present[2 + 5]   # prism side 5 dropped
    assert not present[8 + 5]   # its upper cone face too
    assert not present[14 + 5]
    assert present[0] and present[1]
    check_invariants(g, "drop")


def test_irregular_distances_invariants():
    rs = np.random.default_rng(5)
    for trial in range(12):
        dist = rs.uniform(0.4, 1.6, 6).astype(np.float32)
        h1, h2, h3 = rs.uniform(0.05, 0.95), rs.uniform(0.1, 2.0), rs.uniform(0.05, 0.95)
        au, al = rs.uniform(15, 75), rs.uniform(15, 75)
        g = build(h1=h1, h2=h2, h3=h3, au=float(au), al=float(al), dist=dist)
        check_invariants(g, f"trial{trial}")
        present = np.asarray(g.face_present)
        assert present[1].any() or present[0].any() or present.sum() == 0


def test_batched_pyramid():
    h1 = jnp.asarray([0.3, 0.6], jnp.float32)
    h2 = jnp.asarray([1.0, 0.5], jnp.float32)
    h3 = jnp.asarray([0.3, 0.2], jnp.float32)
    dist = jnp.ones((2, 6), jnp.float32)
    g = pyr.pyramid_geom_batch(h1, h2, h3, 28.0, 28.0, dist)
    assert g.plane_n.shape == (2, 20, 3)
    assert bool(np.asarray(g.face_present).all())


def test_pyramid_traces():
    """Pyramid geometry plugs straight into the trace kernel; energy behaves."""
    from ice_halo_sim_jax.core import sampling, trace

    g = build(h1=0.25, h2=1.0, h3=0.25)
    pool = trace.make_geom_pool(
        jax.tree.map(lambda a: a[None], g),
        jax.tree.map(lambda a: a[None], sampling.build_entry_tris(g)),
    )
    n = 2000
    rs = np.random.default_rng(2)
    lon = jnp.asarray(rs.uniform(0, 2 * np.pi, n), jnp.float32)
    lat = jnp.asarray(np.arcsin(rs.uniform(-1, 1, n)), jnp.float32)
    roll = jnp.asarray(rs.uniform(0, 2 * np.pi, n), jnp.float32)
    rot = sampling.build_rotation(lon, lat, roll)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (n, 1))
    exits = trace.trace_layer(
        3, jnp.arange(n, dtype=jnp.uint32), d, jnp.ones(n), rot,
        jnp.zeros(n, jnp.int32), pool, jnp.full(n, 1.31), 20,
    )
    total = np.asarray(trace.total_exit_weight(exits))
    assert bool(np.asarray(exits.entry_ok).all())
    assert (total <= 1 + 1e-5).all()
    assert total.mean() > 0.95
    # Pyramid face numbers appear in recorded paths.
    paths = np.asarray(exits.path)
    assert ((paths >= 13) & (paths <= 28)).any()

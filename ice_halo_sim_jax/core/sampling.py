"""Ray & orientation sampling: sun cap, crystal orientations, entry faces.

Vectorized jnp mirrors of the reference's single-source device samplers
(/root/reference/src/core/shared/pcg_shared.h):
  - sample_sph_cap (:521-548) — sun-cone incident directions.
  - sample_lat_lon_roll (:392-455) — orientation sampling with the
    area-measure inverse-CDF latitude LUT + pole-flip coupling.
  - build_crystal_rotation_9 (:458-520) — R = Rz(lon-pi) Ry(lat-pi/2) Rz(roll),
    row-major, world = R @ crystal.
  - InitRay_p_fid / BuildEntrySubTris (simulator.cpp:61-192) — projected-area
    weighted entry-face fan-subtriangle sampling.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.schema import AxisDistribution, DistType
from ice_halo_sim_jax.core import rng
from ice_halo_sim_jax.core.geometry import CrystalGeom
from ice_halo_sim_jax.core.latlut import N_NODES

# Latitude-path taxonomy (lat_path_selection.hpp:38-60).
LAT_FULL_SPHERE = 0
LAT_NO_RANDOM = 1
LAT_GAUSS_LEGACY = 3
LAT_LUT_INVERSE_CDF = 6


def select_lat_path(axis: AxisDistribution) -> int:
    if axis.is_full_sphere_uniform():
        return LAT_FULL_SPHERE
    if axis.latitude.type == DistType.NO_RANDOM:
        return LAT_NO_RANDOM
    if axis.latitude.type == DistType.GAUSS_LEGACY:
        return LAT_GAUSS_LEGACY
    return LAT_LUT_INVERSE_CDF


class AxisParams(NamedTuple):
    """Per-setting orientation-sampling parameters, batched [S, ...] over the
    scatter settings of a layer; rays gather their row by setting index."""

    lat_path: jnp.ndarray   # [S] int32
    lat_mean: jnp.ndarray   # [S] radians
    lat_std: jnp.ndarray    # [S] radians
    az_type: jnp.ndarray    # [S] int32
    az_mean: jnp.ndarray    # [S] radians
    az_std: jnp.ndarray     # [S] radians
    roll_type: jnp.ndarray  # [S] int32
    roll_mean: jnp.ndarray  # [S] radians
    roll_std: jnp.ndarray   # [S] radians
    lut_theta: jnp.ndarray  # [S, N_NODES]
    lut_cdf: jnp.ndarray    # [S, N_NODES]
    lut_flip: jnp.ndarray   # [S, N_NODES]


def make_axis_params(axes, luts) -> AxisParams:
    """Pack host AxisDistribution configs (+ prebuilt LatLuts) into arrays.

    Everything stays host-side numpy: the row sampler reads the path/type
    fields as STATIC Python values while tracing (numpy indexing is concrete
    under jit; jnp constants would become tracers)."""
    deg = np.pi / 180.0
    return AxisParams(
        lat_path=np.array([select_lat_path(a) for a in axes], np.int32),
        lat_mean=np.asarray([a.latitude.center * deg for a in axes], np.float32),
        lat_std=np.asarray([a.latitude.spread * deg for a in axes], np.float32),
        az_type=np.asarray([int(a.azimuth.type) for a in axes], np.int32),
        az_mean=np.asarray([a.azimuth.center * deg for a in axes], np.float32),
        az_std=np.asarray([a.azimuth.spread * deg for a in axes], np.float32),
        roll_type=np.asarray([int(a.roll.type) for a in axes], np.int32),
        roll_mean=np.asarray([a.roll.center * deg for a in axes], np.float32),
        roll_std=np.asarray([a.roll.spread * deg for a in axes], np.float32),
        lut_theta=np.stack([l.theta for l in luts]).astype(np.float32),
        lut_cdf=np.stack([l.cdf for l in luts]).astype(np.float32),
        lut_flip=np.stack([l.flip_prob for l in luts]).astype(np.float32),
    )


def sample_sun_dirs(seed, idx, sun_azimuth_deg: float, sun_altitude_deg: float,
                    sun_diameter_deg: float) -> jnp.ndarray:
    """Directions of light PROPAGATION within the sun cone [B, 3].

    SampleRayDir (simulator.cpp:194-196): cap center lon = azimuth + 180 deg,
    lat = -altitude (the travel direction), half-angle = diameter / 2.
    Cap math mirrors sample_sph_cap (pcg_shared.h:521-548).
    """
    lon = jnp.deg2rad(jnp.float32(sun_azimuth_deg + 180.0))
    lat = jnp.deg2rad(jnp.float32(-sun_altitude_deg))
    half = jnp.deg2rad(jnp.float32(sun_diameter_deg / 2.0))
    u = rng.uniform(seed, idx, 0)
    c_cap = jnp.cos(half)
    x = u + (1.0 - u) * c_cap
    r = jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0))
    phi = rng.uniform(seed, idx, 1) * jnp.float32(2 * np.pi)
    y = jnp.cos(phi) * r
    z = jnp.sin(phi) * r
    c_lon, s_lon = jnp.cos(lon), jnp.sin(lon)
    c_lat, s_lat = jnp.cos(lat), jnp.sin(lat)
    return jnp.stack(
        [
            c_lon * c_lat * x - s_lon * y - c_lon * s_lat * z,
            s_lon * c_lat * x + c_lon * y - s_lon * s_lat * z,
            s_lat * x + c_lat * z,
        ],
        axis=-1,
    )


def sample_sun_dirs_soa(seed, idx, sun_azimuth_deg: float, sun_altitude_deg: float,
                        sun_diameter_deg: float):
    """sample_sun_dirs in component form: returns (dx, dy, dz) each [B]
    (same RNG slots 0-1, same math — no [B, 3] stack in the hot path)."""
    lon = jnp.deg2rad(jnp.float32(sun_azimuth_deg + 180.0))
    lat = jnp.deg2rad(jnp.float32(-sun_altitude_deg))
    half = jnp.deg2rad(jnp.float32(sun_diameter_deg / 2.0))
    u = rng.uniform(seed, idx, 0)
    c_cap = jnp.cos(half)
    x = u + (1.0 - u) * c_cap
    r = jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0))
    phi = rng.uniform(seed, idx, 1) * jnp.float32(2 * np.pi)
    y = jnp.cos(phi) * r
    z = jnp.sin(phi) * r
    c_lon, s_lon = jnp.cos(lon), jnp.sin(lon)
    c_lat, s_lat = jnp.cos(lat), jnp.sin(lat)
    return (
        c_lon * c_lat * x - s_lon * y - c_lon * s_lat * z,
        s_lon * c_lat * x + c_lon * y - s_lon * s_lat * z,
        s_lat * x + c_lat * z,
    )


def invert_lat_lut(xi, theta_nodes, cdf_nodes):
    """Inverse-CDF lookup (pcg_shared.h:345-370).

    xi: [B]; theta_nodes/cdf_nodes: [N_NODES] shared tables (one axis
    distribution per call — settings are processed as contiguous segments).

    ONE fused [B, N] masked pass instead of gathers/one-hots: the CDF is
    strictly monotone (build_lat_lut lifts it), so cdf[lo] is the masked
    MAX of nodes <= xi (excluding the last node, matching lo's clip to
    N-2) and cdf[lo+1] the masked MIN of nodes > xi; theta nodes are
    UNIFORMLY spaced, so theta[lo] is arithmetic.
    """
    xi = jnp.clip(xi, cdf_nodes[0], cdf_nodes[-1])
    n = cdf_nodes.shape[0]
    node_i = jnp.arange(n, dtype=jnp.int32)
    cmp = cdf_nodes[None, :] <= xi[..., None]                    # [B, N]
    lo = jnp.clip(jnp.sum(cmp.astype(jnp.int32), axis=-1) - 1, 0, n - 2)
    neg = jnp.float32(-3.0e38)
    pos = jnp.float32(3.0e38)
    c0 = jnp.max(
        jnp.where(cmp & (node_i[None, :] < n - 1), cdf_nodes[None, :], neg),
        axis=-1,
    )
    c1 = jnp.min(
        jnp.where(~cmp, cdf_nodes[None, :], pos), axis=-1
    )
    c1 = jnp.minimum(c1, cdf_nodes[-1])
    t0 = theta_nodes[0]
    dt = (theta_nodes[-1] - theta_nodes[0]) / jnp.float32(n - 1)
    denom = c1 - c0
    w = jnp.where(denom > 0, (xi - c0) / jnp.where(denom > 0, denom, 1.0), 0.0)
    return t0 + (lo.astype(jnp.float32) + w) * dt


def lat_lut_bin(theta, theta_nodes):
    """O(1) uniform-theta bin index (pcg_shared.h:373-388)."""
    span = theta_nodes[-1] - theta_nodes[0]
    t = jnp.where(span > 0, (theta - theta_nodes[0]) / jnp.where(span > 0, span, 1.0), 0.0)
    idx = (t * (N_NODES - 1)).astype(jnp.int32)
    return jnp.clip(idx, 0, N_NODES - 2)


def normalize_latitude(phi):
    """Vectorized spherical latitude fold -> (phi_norm, flip)
    (pcg_shared.h:313-325)."""
    theta = jnp.float32(np.pi / 2) - phi
    theta = jnp.mod(theta, jnp.float32(2 * np.pi))
    flip = theta > jnp.float32(np.pi)
    theta = jnp.where(flip, jnp.float32(2 * np.pi) - theta, theta)
    return jnp.float32(np.pi / 2) - theta, flip


def sample_lat_lon_roll_row(seed, idx, params: AxisParams, s: int):
    """Orientation (lon, lat, roll) in radians for rays of ONE setting.

    Mirror of sample_lat_lon_roll (pcg_shared.h:392-455) with the setting's
    parameters selected by the STATIC index `s` (settings occupy contiguous
    lane segments, so per-ray parameter gathers never exist). The latitude
    path is a host constant per setting, so only that branch is traced.
    Pole flips add pi to both lon and roll. Slots 0..9 consumed here.
    """
    lat_path = int(params.lat_path[s])
    lat_mean = params.lat_mean[s]

    if lat_path == LAT_FULL_SPHERE:
        u_fs = rng.uniform(seed, idx, 0) * 2.0 - 1.0
        phi = jnp.arcsin(jnp.clip(u_fs, -1.0, 1.0))
        flip = jnp.zeros(idx.shape, bool)
    elif lat_path == LAT_NO_RANDOM:
        phi = jnp.broadcast_to(lat_mean, idx.shape)
        flip = jnp.zeros(idx.shape, bool)
    elif lat_path == LAT_GAUSS_LEGACY:
        raw = rng.sample_dist(seed, idx, 2, int(DistType.GAUSS_LEGACY), lat_mean, params.lat_std[s])
        phi, flip = normalize_latitude(raw)
    else:  # LAT_LUT_INVERSE_CDF
        xi = rng.uniform(seed, idx, 4)
        theta_nodes = jnp.asarray(params.lut_theta[s])
        colat = invert_lat_lut(xi, theta_nodes, jnp.asarray(params.lut_cdf[s]))
        phi = jnp.float32(np.pi / 2) - colat
        flip_tbl = jnp.asarray(params.lut_flip[s])
        fbin = lat_lut_bin(colat, theta_nodes)
        flip_p = flip_tbl[fbin]
        flip = rng.uniform(seed, idx, 5) < flip_p

    # Azimuth (slots 6-7) and roll (slots 8-9).
    if lat_path == LAT_FULL_SPHERE:
        lon = rng.uniform(seed, idx, 1) * jnp.float32(2 * np.pi)
    else:
        lon = rng.sample_dist(seed, idx, 6, int(params.az_type[s]), params.az_mean[s],
                              params.az_std[s])
    roll = rng.sample_dist(seed, idx, 8, int(params.roll_type[s]), params.roll_mean[s],
                           params.roll_std[s])

    pi = jnp.float32(np.pi)
    lon = jnp.where(flip, lon + pi, lon)
    roll = jnp.where(flip, roll + pi, roll)
    return lon, phi, roll


def _rot9(ca, sa, cb, sb, cc, sc):
    """Row-major R = Rz(a) @ Ry(b) @ Rz(c) from the six cos/sin values
    (same closed form as trace_soa.rot_components / build_rotation)."""
    return (
        ca * cb * cc - sa * sc, -ca * cb * sc - sa * cc, ca * sb,
        sa * cb * cc + ca * sc, -sa * cb * sc + ca * cc, sa * sb,
        -sb * cc, sb * sc, cb,
    )


def sample_rot_row(seed, idx, params: AxisParams, s: int):
    """Orientation sample -> the 9 rotation components directly, for rays of
    ONE setting (same RNG slots/streams as sample_lat_lon_roll_row).

    The full-sphere path is CLOSED FORM: with u = 2*xi - 1 the rotation
    needs only cb = cos(phi - pi/2) = sin(phi) = u and sb = -cos(phi) =
    -sqrt(1 - u^2) — no arcsin. That saves an arcsin+cos+sin chain; the
    sampled rotation is identical up to ulps (sin(arcsin(u)) == u).
    """
    pi = jnp.float32(np.pi)
    lat_path = int(params.lat_path[s])
    lat_mean = params.lat_mean[s]
    flip = None

    if lat_path == LAT_FULL_SPHERE:
        u_fs = rng.uniform(seed, idx, 0) * 2.0 - 1.0
        u_fs = jnp.clip(u_fs, -1.0, 1.0)
        cb = u_fs
        sb = -jnp.sqrt(jnp.maximum(1.0 - u_fs * u_fs, 0.0))
        lon = rng.uniform(seed, idx, 1) * jnp.float32(2 * np.pi)
    else:
        if lat_path == LAT_NO_RANDOM:
            phi = jnp.broadcast_to(lat_mean, jnp.shape(idx)).astype(jnp.float32)
        elif lat_path == LAT_GAUSS_LEGACY:
            raw = rng.sample_dist(
                seed, idx, 2, int(DistType.GAUSS_LEGACY), lat_mean,
                params.lat_std[s],
            )
            phi, flip = normalize_latitude(raw)
        else:  # LAT_LUT_INVERSE_CDF
            xi = rng.uniform(seed, idx, 4)
            theta_nodes = params.lut_theta[s]
            cdf_nodes = params.lut_cdf[s]
            flip_tbl = params.lut_flip[s]
            theta_j = jnp.asarray(theta_nodes)
            colat = invert_lat_lut(xi, theta_j, jnp.asarray(cdf_nodes))
            fbin = lat_lut_bin(colat, theta_j)
            flip_p = jnp.asarray(flip_tbl)[fbin]
            phi = jnp.float32(np.pi / 2) - colat
            flip = rng.uniform(seed, idx, 5) < flip_p
        b = phi - pi / 2
        cb = jnp.cos(b)
        sb = jnp.sin(b)
        lon = rng.sample_dist(
            seed, idx, 6, int(params.az_type[s]), params.az_mean[s],
            params.az_std[s],
        )
    roll = rng.sample_dist(
        seed, idx, 8, int(params.roll_type[s]), params.roll_mean[s],
        params.roll_std[s],
    )
    if flip is not None:
        lon = jnp.where(flip, lon + pi, lon)
        roll = jnp.where(flip, roll + pi, roll)
    a = lon - pi
    return _rot9(
        jnp.cos(a), jnp.sin(a), cb, sb, jnp.cos(roll), jnp.sin(roll)
    )


def sample_lat_lon_roll(seed, idx, params: AxisParams, setting_idx):
    """Compatibility wrapper: single-setting params ([1, ...]) only; the
    engine samples per contiguous setting segment via the row API."""
    return sample_lat_lon_roll_row(seed, idx, params, 0)


def build_rotation(lon, lat, roll):
    """Row-major rotation R = Rz(lon - pi) @ Ry(lat - pi/2) @ Rz(roll),
    [..., 3, 3]; world = R @ crystal (BuildCrystalRotation, simulator.cpp:224-231).
    """
    pi = jnp.float32(np.pi)
    a = lon - pi
    b = lat - pi / 2
    c = roll
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cc, sc = jnp.cos(c), jnp.sin(c)
    # Rz(a) @ Ry(b) @ Rz(c), composed in closed form.
    r00 = ca * cb * cc - sa * sc
    r01 = -ca * cb * sc - sa * cc
    r02 = ca * sb
    r10 = sa * cb * cc + ca * sc
    r11 = -sa * cb * sc + ca * cc
    r12 = sa * sb
    r20 = -sb * cc
    r21 = sb * sc
    r22 = cb
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotate(rot, v):
    """world = R @ crystal; rot [..., 3, 3], v [..., 3]."""
    return jnp.einsum("...ij,...j->...i", rot, v, precision="highest")


def rotate_inv(rot, v):
    """crystal = R^T @ world."""
    return jnp.einsum("...ji,...j->...i", rot, v, precision="highest")


# --------------------------------------------------------------------------
# Entry-face sampling
# --------------------------------------------------------------------------

def _take_row(arr, idx):
    """arr [..., N, C] + idx [...] -> [..., C]: one row per ray."""
    return jnp.take_along_axis(arr, idx[..., None, None], axis=-2)[..., 0, :]


def _take_col(arr, idx):
    """arr [..., N] (or a shared [N] table) + idx [...] -> [...]."""
    if arr.ndim == 1:
        return arr[idx]
    return jnp.take_along_axis(arr, idx[..., None], axis=-1)[..., 0]


class EntryTris(NamedTuple):
    """Per-shape fan sub-triangle table, [..., T, ...] with T = NF*(MV-2).

    Mirrors detail::BuildEntrySubTris (simulator.cpp:90-129): fan (v0, v[k],
    v[k+1]), raw winding normal, area from the cross product. Absent /
    degenerate triangles carry zero cross -> zero selection weight.
    """

    v0: jnp.ndarray          # [..., T, 3]
    e1: jnp.ndarray          # [..., T, 3] v[k] - v0
    e2: jnp.ndarray          # [..., T, 3] v[k+1] - v0
    cross_half: jnp.ndarray  # [..., T, 3] 0.5 * (e1 x e2) = area * normal
    face_idx: jnp.ndarray    # [..., T] owning face slot (int32)


def build_entry_tris(geom: CrystalGeom) -> EntryTris:
    nf, mv, _ = geom.face_vtx.shape[-3:]
    # Hexagonal-family faces carry at most 6 distinct vertices (6 side
    # half-planes bound the cross-section); vertex slots beyond 6 are padding
    # duplicates that would only add zero-area fan triangles, so slicing to
    # 6 shrinks the per-ray entry-sampling table 2.5x (T = NF*4).
    mv = min(mv, 6)
    face_vtx = geom.face_vtx[..., :mv, :]
    v0 = face_vtx[..., 0:1, :]                          # [NF, 1, 3]
    e1 = face_vtx[..., 1:-1, :] - v0                    # [NF, MV-2, 3]
    e2 = face_vtx[..., 2:, :] - v0
    cross_half = 0.5 * jnp.cross(e1, e2)
    k = jnp.arange(1, mv - 1)
    valid = (k[None, :] + 1 < geom.face_vtx_cnt[..., None]) & geom.face_present[..., None]
    cross_half = jnp.where(valid[..., None], cross_half, 0.0)
    t = nf * (mv - 2)
    face_idx = jnp.broadcast_to(
        jnp.arange(nf, dtype=jnp.int32)[:, None], (nf, mv - 2)
    )
    batch_shape = geom.face_vtx.shape[:-3]
    return EntryTris(
        v0=jnp.broadcast_to(v0, e1.shape).reshape(batch_shape + (t, 3)),
        e1=e1.reshape(batch_shape + (t, 3)),
        e2=e2.reshape(batch_shape + (t, 3)),
        cross_half=cross_half.reshape(batch_shape + (t, 3)),
        face_idx=jnp.broadcast_to(face_idx, batch_shape + (nf, mv - 2)).reshape(batch_shape + (t,)),
    )


def sample_entry(seed, idx, d_local, tris: EntryTris):
    """Entry point + face for rays with crystal-frame direction d_local [B,3].

    tris carries per-ray gathered tables [B, T, ...]. Projected-area weights
    w_t = max(-d . cross_half, 0) (InitRay_p_fid, simulator.cpp:175-186);
    categorical CDF selection mirrors RandomSample / categorical_sample
    (pcg_shared.h:607-626); point-in-triangle uses the (u, v) fold
    (sample_triangle, :496-518). Consumes slots 10-12.

    Returns (p [B,3], face_idx [B] int32, has_entry [B] bool).
    """
    w = jnp.maximum(-jnp.sum(d_local[..., None, :] * tris.cross_half, axis=-1), 0.0)  # [B, T]
    total = jnp.sum(w, axis=-1)
    has_entry = total > 0.0
    cdf = jnp.cumsum(w, axis=-1)
    target = rng.uniform(seed, idx, 10) * total
    sel = jnp.sum((cdf <= target[..., None]).astype(jnp.int32), axis=-1)
    sel = jnp.clip(sel, 0, w.shape[-1] - 1)

    # Per-ray reads along the (small) sub-triangle axis.
    v0 = _take_row(tris.v0, sel)
    e1 = _take_row(tris.e1, sel)
    e2 = _take_row(tris.e2, sel)
    u = rng.uniform(seed, idx, 11)
    v = rng.uniform(seed, idx, 12)
    over = u + v > 1.0
    u = jnp.where(over, 1.0 - u, u)
    v = jnp.where(over, 1.0 - v, v)
    p = v0 + u[..., None] * e1 + v[..., None] * e2
    face = _take_col(tris.face_idx, sel)

    # Log selection probability of the chosen sub-triangle — the score
    # function for REINFORCE-style gradients through the discrete entry
    # choice (gradient.py). Detached lanes (total = 0) return 0.
    w_sel = _take_col(w, sel)
    safe_total = jnp.where(has_entry, total, 1.0)
    log_p = jnp.where(
        has_entry & (w_sel > 0),
        jnp.log(jnp.where(w_sel > 0, w_sel, 1.0)) - jnp.log(safe_total),
        0.0,
    )
    return p, face, has_entry, log_p


# Number of RNG slots consumed by orientation (0-9) + entry (10-12) sampling.
ORIENT_SLOTS = 10
ENTRY_SLOTS = 3

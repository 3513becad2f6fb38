"""Optics: ice refractive index, Fresnel split, convex-slab traversal.

Numerical contracts mirrored from the reference:
  - IceRefractiveIndex::Get — Sellmeier fit, 350..900 nm
    (/root/reference/src/core/optics.cpp:180-198, coefficients optics.hpp:29-31).
  - GetReflectRatio — unpolarized Fresnel (optics_shared.h:17-24).
  - HitSurface — signed-cos Fresnel split with TIR (optics.cpp:18-53).
  - SlabFaceT + PropagateSlab — per-plane exit-t for a convex slab with the
    denominator gate and source-face exclusion (traversal_shared.h:60-75,
    optics.cpp:64-158).

All functions are pure jnp over batched ray arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Sellmeier fit coefficients B1, B2, C1, C2 (optics.hpp:29 kCoefAvr).
_SELLMEIER = (0.701777, 1.091144, 0.884400, 0.796950)
WL_MIN = 350.0
WL_MAX = 900.0

SLAB_EPS = 1e-5  # traversal_shared.h kSlabEps == math::kFloatEps
_BIG = 1e30


def ice_refractive_index(wl_nm):
    """n(lambda) for ice; 1.0 outside [350, 900] nm (optics.cpp:180-198).

    n^2 = 1 + B1 / (1 - C1*1e-2 / um^2) + B2 / (1 - C2*1e2 / um^2).
    """
    wl_nm = jnp.asarray(wl_nm, jnp.float32)
    um = wl_nm / 1e3
    b1, b2, c1, c2 = _SELLMEIER
    n_sq = 1.0 + b1 / (1.0 - c1 * 1e-2 / (um * um)) + b2 / (1.0 - c2 * 1e2 / (um * um))
    n = jnp.sqrt(jnp.maximum(n_sq, 1.0))
    return jnp.where((wl_nm < WL_MIN) | (wl_nm > WL_MAX), 1.0, n)


def reflect_ratio(delta, rr):
    """Unpolarized Fresnel R = (Rs + Rp) / 2 (optics_shared.h:17-24).

    delta must be clamped >= 0 by the caller; rr is the relative refractive
    index along the ray direction.
    """
    d_sqrt = jnp.sqrt(delta)
    rs = (rr - d_sqrt) / (rr + d_sqrt)
    rp = (1.0 - rr * d_sqrt) / (1.0 + rr * d_sqrt)
    return 0.5 * (rs * rs + rp * rp)


def fresnel_split(d, n_face, w, n_ior):
    """Fresnel interaction of rays `d` [..., 3] with faces of outward normal
    `n_face` [..., 3] at refractive index n_ior [...] (HitSurface,
    optics.cpp:18-53).

    Returns (d_reflect, d_refract, w_reflect, w_refract, is_tir).
    cos_theta > 0 means the ray travels outward (inside -> out).
    For TIR the refracted child carries zero weight and the reflected
    direction (the reference marks it with the w = -1 sentinel; we use an
    explicit boolean + zero weight, which is the fixed-shape formulation its
    CUDA kernel also uses, cuda_trace_backend.cu:1070-1086).
    """
    cos_theta = jnp.sum(d * n_face, axis=-1)
    rr = jnp.where(cos_theta > 0, n_ior, 1.0 / n_ior)
    cos_sq = cos_theta * cos_theta
    delta = (1.0 - rr * rr) / jnp.maximum(cos_sq, 1e-20) + rr * rr
    is_tir = delta <= 0.0
    # Double-where: sqrt'(0) = inf would leak NaN through the masked TIR
    # branch in reverse mode (the jnp.where gradient trap).
    delta_safe = jnp.where(is_tir, 1.0, jnp.maximum(delta, 0.0))
    r_ratio = jnp.where(is_tir, 1.0, reflect_ratio(delta_safe, rr))
    w_reflect = r_ratio * w
    w_refract = jnp.where(is_tir, 0.0, w - w_reflect)

    ct = cos_theta[..., None]
    d_reflect = d - 2.0 * ct * n_face
    sd = jnp.sqrt(delta_safe)[..., None]
    rr_b = rr[..., None]
    d_refract_raw = rr_b * d - (rr_b - sd) * ct * n_face
    d_refract = jnp.where(is_tir[..., None], d_reflect, d_refract_raw)
    return d_reflect, d_refract, w_reflect, w_refract, is_tir


def slab_next_face(p, d, from_face, plane_n, plane_d, face_present):
    """Next exit face of a convex slab (PropagateSlab, optics.cpp:64-158).

    p, d: [..., 3] ray origin/direction (crystal frame).
    from_face: [...] int32 source face index (-1 = none) — excluded from the
      search (CUDA-style explicit skip, cuda_trace_backend.cu:1030-1032).
    plane_n: [..., NF, 3], plane_d: [..., NF], face_present: [..., NF].

    Returns (t, face_idx, found): min positive-ish t over candidate faces
    (denominator > SLAB_EPS, reference gate), face index int32, and a bool
    that is False when no face qualifies (ray is leaving the hull — the
    "outgoing" classification) or t <= -SLAB_EPS (anomalous geometry).
    """
    denom = jnp.sum(d[..., None, :] * plane_n, axis=-1)              # [..., NF]
    dist = jnp.sum(p[..., None, :] * plane_n, axis=-1) + plane_d     # [..., NF]
    t_face = -dist / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
    nf = plane_n.shape[-2]
    face_ids = jnp.arange(nf, dtype=jnp.int32)
    candidate = (denom > SLAB_EPS) & face_present & (face_ids != from_face[..., None])
    t_masked = jnp.where(candidate, t_face, _BIG)
    face_idx = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
    # min == value at argmin, without a per-ray gather.
    t = jnp.min(t_masked, axis=-1)
    # Accept slightly negative t (TIR-edge hits just inside the source face,
    # optics.cpp:138-143 / cuda_trace_backend.cu:1046-1051).
    found = (t < _BIG * 0.5) & (t > -SLAB_EPS)
    return t, face_idx, found

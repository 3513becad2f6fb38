"""Spectral color: CIE CMF lookup, XYZ accumulation, sRGB post-processing.

Contracts mirrored from the reference:
  - SpectrumToXyz wavelength rounding + [360, 830] clip
    (/root/reference/src/core/color_util.hpp:20-46).
  - kNormScale = 0.08 display baseline (color_util.hpp:14-19).
  - ExposureScale = intensity_factor * kNormScale * total_pix /
    snapshot_intensity (render.cpp:96-102).
  - GamutClipXyz / XyzToLinearRgb / LinearToSrgb (util/color_space.cpp) and
    the fused PostSnapshot pipeline (render.cpp:508-578).
  - D65 standard-illuminant SPD via the CIE daylight components
    (util/illuminant.cpp).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

_DATA = np.load(os.path.join(os.path.dirname(__file__), "..", "data", "cie_data.npz"))

CMF_WL_MIN = int(_DATA["cmf_wl_min"])   # 360
CMF_WL_MAX = int(_DATA["cmf_wl_max"])   # 830
CMF_X = _DATA["cmf_x"].astype(np.float32)
CMF_Y = _DATA["cmf_y"].astype(np.float32)
CMF_Z = _DATA["cmf_z"].astype(np.float32)
XYZ_TO_RGB = _DATA["xyz_to_rgb"].astype(np.float32)    # [3, 3] row-major
WHITE_D65 = _DATA["white_d65"].astype(np.float32)      # [3]
NORM_SCALE = 0.08

_DAYLIGHT_S = np.stack([_DATA["daylight_s0"], _DATA["daylight_s1"], _DATA["daylight_s2"]])
_DAYLIGHT_WL_MIN = int(_DATA["daylight_wl_min"])
_DAYLIGHT_WL_STEP = int(_DATA["daylight_wl_step"])


def cmf_lookup(wl_nm):
    """CMF (x, y, z) triple for wavelengths [B] with the reference's rounding
    + range clip; out-of-range wavelengths return zeros. -> [B, 3]."""
    wl_key = jnp.floor(jnp.asarray(wl_nm, jnp.float32) + 0.5).astype(jnp.int32)
    in_range = (wl_key >= CMF_WL_MIN) & (wl_key <= CMF_WL_MAX)
    idx = jnp.clip(wl_key - CMF_WL_MIN, 0, CMF_WL_MAX - CMF_WL_MIN)
    triple = jnp.stack(
        [jnp.asarray(CMF_X)[idx], jnp.asarray(CMF_Y)[idx], jnp.asarray(CMF_Z)[idx]], axis=-1
    )
    return jnp.where(in_range[..., None], triple, 0.0)


def daylight_cct_spd(cct: float, wl_nm):
    """Daylight-series SPD at correlated color temperature `cct` for
    wavelengths [B] (CIE method; util/illuminant.cpp)."""
    t = cct
    if t <= 7000:
        xd = -4.607e9 / t**3 + 2.9678e6 / t**2 + 0.09911e3 / t + 0.244063
    else:
        xd = -2.0064e9 / t**3 + 1.9018e6 / t**2 + 0.24748e3 / t + 0.23704
    yd = -3.0 * xd * xd + 2.87 * xd - 0.275
    m = 0.0241 + 0.2562 * xd - 0.7341 * yd
    m1 = (-1.3515 - 1.7703 * xd + 5.9114 * yd) / m
    m2 = (0.03 - 31.4424 * xd + 30.0717 * yd) / m
    s = jnp.asarray(_DAYLIGHT_S, jnp.float32)
    pos = (jnp.asarray(wl_nm, jnp.float32) - _DAYLIGHT_WL_MIN) / _DAYLIGHT_WL_STEP
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, s.shape[1] - 2)
    f = jnp.clip(pos - i0, 0.0, 1.0)
    interp = s[:, i0] * (1 - f) + s[:, i0 + 1] * f
    return interp[0] + m1 * interp[1] + m2 * interp[2]


ILLUMINANT_CCT = {"D50": 5003.0, "D55": 5503.0, "D65": 6504.0, "D75": 7504.0}


def illuminant_spd(name: str, wl_nm):
    """SPD weight for a standard illuminant at wavelengths [B]."""
    name = name.upper()
    if name in ILLUMINANT_CCT:
        # Raw S0 + m1 S1 + m2 S2 reconstruction; the basis tables already
        # carry the ~100-at-560nm scale (illuminant.cpp:59-87, no renorm).
        return daylight_cct_spd(ILLUMINANT_CCT[name], wl_nm)
    if name == "E":
        return jnp.ones(jnp.asarray(wl_nm).shape, jnp.float32)
    if name == "A":
        # Planck blackbody at 2856 K, normalized to 100 at 560 nm.
        c2 = 1.435e7  # nm*K
        temp = 2856.0
        wl = jnp.asarray(wl_nm, jnp.float32)
        ratio = 560.0 / wl
        num = np.exp(c2 / (temp * 560.0)) - 1.0
        den = jnp.exp(c2 / (temp * wl)) - 1.0
        return 100.0 * ratio**5 * num / den
    raise ValueError(f"unknown illuminant {name!r}")


def exposure_scale(intensity_factor: float, total_pix: int, snapshot_intensity: float) -> float:
    """render.cpp:96-102 (0 when nothing landed)."""
    if total_pix <= 0 or snapshot_intensity <= 0:
        return 0.0
    return intensity_factor * NORM_SCALE * total_pix / snapshot_intensity


def gamut_clip_xyz(xyz):
    """Project out-of-gamut XYZ toward the D65 gray axis
    (color_space.cpp:GamutClipXyz). xyz: [..., 3]."""
    white = jnp.asarray(WHITE_D65)
    m = jnp.asarray(XYZ_TO_RGB)
    gray = white * xyz[..., 1:2]
    diff = xyz - gray
    a = -jnp.einsum("...k,jk->...j", gray, m, precision="highest")
    b = jnp.einsum("...k,jk->...j", diff, m, precision="highest")
    ratio = jnp.where(jnp.abs(b) > 1e-30, a / jnp.where(jnp.abs(b) > 1e-30, b, 1.0), jnp.inf)
    cand = jnp.where(a * b > 0, ratio, jnp.inf)
    s = jnp.minimum(jnp.min(cand, axis=-1), 1.0)
    return diff * s[..., None] + gray


def xyz_to_linear_rgb(xyz):
    """[..., 3] XYZ -> clamped linear RGB (color_space.cpp:XyzToLinearRgb)."""
    rgb = jnp.einsum("...k,jk->...j", xyz, jnp.asarray(XYZ_TO_RGB),
                     precision="highest")
    return jnp.clip(rgb, 0.0, 1.0)


def linear_to_srgb(x):
    return jnp.where(x < 0.0031308, x * 12.92, 1.055 * jnp.power(jnp.maximum(x, 1e-12), 1.0 / 2.4) - 0.055)


def post_process(xyz_image, intensity_factor: float, snapshot_intensity: float,
                 background, ray_color, use_real_color: bool = True):
    """Fused snapshot post-processing (render.cpp:508-578).

    xyz_image: [H, W, 3] accumulated XYZ; returns uint8 [H, W, 3] sRGB.
    use_real_color=False uses the D65-gray luminance path tinted by ray_color.
    """
    h, w, _ = xyz_image.shape
    scale = exposure_scale(intensity_factor, h * w, snapshot_intensity)
    xyz = xyz_image * scale
    if use_real_color:
        rgb = xyz_to_linear_rgb(gamut_clip_xyz(xyz))
    else:
        gray = jnp.asarray(WHITE_D65) * xyz[..., 1:2]
        rgb = jnp.einsum("...k,jk->...j", gray, jnp.asarray(XYZ_TO_RGB),
                         precision="highest")
        rgb = rgb * jnp.asarray(ray_color, jnp.float32)
    rgb = rgb + jnp.asarray(background, jnp.float32)
    rgb = jnp.clip(rgb, 0.0, 1.0)
    srgb = linear_to_srgb(rgb)
    return (srgb * 255.0).astype(jnp.uint8)


# --------------------------------------------------------------------------
# Chebyshev fast paths (engine hot path)
# --------------------------------------------------------------------------
#
# The table-exact functions above keep the reference's nearest-nm lookup
# semantics for validation; the engine's hot path evaluates Chebyshev fits
# of the same tables instead — pure fused multiply-adds. Fit
# residuals are bounded by tests (test_color.py) well below the tables' own
# nearest-nm quantization error.

def _chebfit_domain(xs, ys, deg, lo, hi):
    t = (2.0 * np.asarray(xs, np.float64) - (lo + hi)) / (hi - lo)
    return np.polynomial.chebyshev.chebfit(t, np.asarray(ys, np.float64), deg)


def _clenshaw(coeffs, t):
    """Evaluate a Chebyshev series at t in [-1, 1] (vectorized, unrolled)."""
    b1 = jnp.zeros_like(t)
    b2 = jnp.zeros_like(t)
    for ck in coeffs[:0:-1]:
        b1, b2 = jnp.float32(ck) + 2.0 * t * b1 - b2, b1
    return jnp.float32(coeffs[0]) + t * b1 - b2


_CMF_GRID = np.arange(CMF_WL_MIN, CMF_WL_MAX + 1, dtype=np.float64)

# Piecewise Chebyshev: 8 equal-width segments x degree 20 per channel.
# Worst residual 1.5e-4 of peak — better than a single degree-150 series
# (2-4e-4) at ~6x fewer per-ray ops: the per-row work is one gather of the
# segment's coefficient row plus a single degree-20 Clenshaw with per-row
# coefficient vectors.
_CMF_NSEG = 8
_CMF_DEG = 20


def _build_cmf_piecewise():
    edges = np.linspace(CMF_WL_MIN, CMF_WL_MAX, _CMF_NSEG + 1)
    coefs = np.zeros((_CMF_NSEG, 3 * (_CMF_DEG + 1)), np.float32)
    for s in range(_CMF_NSEG):
        m = (_CMF_GRID >= edges[s]) & (_CMF_GRID <= edges[s + 1])
        t = (2 * _CMF_GRID[m] - (edges[s] + edges[s + 1])) / (edges[s + 1] - edges[s])
        for c, tbl in enumerate((CMF_X, CMF_Y, CMF_Z)):
            fit = np.polynomial.chebyshev.chebfit(t, np.asarray(tbl, np.float64)[m], _CMF_DEG)
            coefs[s, c * (_CMF_DEG + 1) : (c + 1) * (_CMF_DEG + 1)] = fit
    return coefs


_CMF_PIECEWISE = _build_cmf_piecewise()


def _clenshaw_rows(coefs, t):
    """Clenshaw with per-row coefficient vectors coefs [B, DEG+1], t [B]."""
    b1 = jnp.zeros_like(t)
    b2 = jnp.zeros_like(t)
    for k in range(coefs.shape[-1] - 1, 0, -1):
        b1, b2 = coefs[..., k] + 2.0 * t * b1 - b2, b1
    return coefs[..., 0] + t * b1 - b2


def cmf_eval(wl_nm):
    """CMF triple [B, 3] (piecewise Chebyshev fit of the 1-nm tables; f32
    residual ~1.5e-4 of peak, below the tables' own nearest-nm
    quantization)."""
    wl = jnp.asarray(wl_nm, jnp.float32)
    seg_w = (CMF_WL_MAX - CMF_WL_MIN) / _CMF_NSEG
    pos = (wl - CMF_WL_MIN) / seg_w
    s = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, _CMF_NSEG - 1)
    t = jnp.clip((pos - s) * 2.0 - 1.0, -1.0, 1.0)
    coefs = jnp.asarray(_CMF_PIECEWISE)[s]                  # [B, 3*(DEG+1)]
    n = _CMF_DEG + 1
    triple = jnp.stack(
        [_clenshaw_rows(coefs[..., c * n : (c + 1) * n], t) for c in range(3)],
        axis=-1,
    )
    in_range = (wl >= CMF_WL_MIN - 0.5) & (wl <= CMF_WL_MAX + 0.5)
    # The fit can ring slightly negative near the zero tails; CMFs are
    # nonnegative by definition.
    return jnp.where(in_range[..., None], jnp.maximum(triple, 0.0), 0.0)


def dense_lerp(x, lo, step, table):
    """Linear table interpolation: table[i0], table[i0+1] gathered and
    lerped. x: [B]; table: [N] host/np array.
    """
    tbl = jnp.asarray(table, jnp.float32)
    n = tbl.shape[0]
    pos = (jnp.asarray(x, jnp.float32) - lo) / step
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 2)
    f = jnp.clip(pos - i0, 0.0, 1.0)
    return tbl[i0] * (1.0 - f) + tbl[i0 + 1] * f


def daylight_components(wl_nm):
    """Daylight S0/S1/S2 at wavelengths [B] -> [3, B] (exact linear
    interpolation of the CIE tables: ONE gather of a row of the stacked
    [N, 6] (v0, v1) table)."""
    tbl = np.stack([np.asarray(_DAYLIGHT_S[i], np.float32) for i in range(3)], axis=-1)
    pairs = np.concatenate([tbl[:-1], tbl[1:]], axis=-1)          # [N-1, 6]
    n = pairs.shape[0]
    pos = (jnp.asarray(wl_nm, jnp.float32) - float(_DAYLIGHT_WL_MIN)) / float(_DAYLIGHT_WL_STEP)
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 1)
    f = jnp.clip(pos - i0, 0.0, 1.0)
    v = jnp.asarray(pairs)[i0]                                    # [B, 6]
    out = v[..., :3] * (1.0 - f)[..., None] + v[..., 3:] * f[..., None]
    return jnp.moveaxis(out, -1, 0)


def illuminant_spd_fast(name: str, wl_nm):
    """Illuminant SPD (engine hot path)."""
    name = name.upper()
    if name in ILLUMINANT_CCT:
        cct = ILLUMINANT_CCT[name]
        if cct <= 7000:
            xd = -4.607e9 / cct**3 + 2.9678e6 / cct**2 + 0.09911e3 / cct + 0.244063
        else:
            xd = -2.0064e9 / cct**3 + 1.9018e6 / cct**2 + 0.24748e3 / cct + 0.23704
        yd = -3.0 * xd * xd + 2.87 * xd - 0.275
        m = 0.0241 + 0.2562 * xd - 0.7341 * yd
        m1 = (-1.3515 - 1.7703 * xd + 5.9114 * yd) / m
        m2 = (0.03 - 31.4424 * xd + 30.0717 * yd) / m
        s = daylight_components(wl_nm)
        return s[0] + jnp.float32(m1) * s[1] + jnp.float32(m2) * s[2]
    return illuminant_spd(name, wl_nm)  # E/A are already analytic

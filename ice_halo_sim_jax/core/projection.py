"""Lens projections: world exit direction -> pixel, all 11 lens models.

Vectorized jnp port of the reference's single-source forward projection
(/root/reference/src/core/shared/projection_shared.h:42-375) and its host
parameter builder (src/core/lens_proj_build.hpp). Per-renderer parameters are
resolved on the host into a small static ProjPlan (lens type and layout are
Python-level constants, so each renderer's projector traces as straight-line
code); the per-ray math is pure jnp.

Conventions mirrored exactly:
  - sky direction = -(exit direction); camera frame c = R^T(-w).
  - single-lens screen handedness x = -x (projection_shared.h:237-243).
  - dual fisheye: upper hemisphere -> left circle with (x,y) -> (-y, x)
    screen mapping, lower -> right circle mirrored (:180-196).
  - globe: outside-in view, camera at distance D=4, cull cz >= -1/D, x
    negated (:300-375).
  - pixel = floor(x * scale + W/2 + 0.5 + shift).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.schema import LensType, RenderConfig, VisibleRange


class ProjPlan(NamedTuple):
    """Host-predigested projection parameters for one renderer."""

    lens_type: int          # static
    width: int
    height: int
    visible: int            # static VisibleRange
    shift_x: int
    shift_y: int
    scale: float
    az0: float
    r_scale: float
    max_abs_dz: float
    rot: np.ndarray         # [3, 3] row-major camera rotation


GLOBE_CAMERA_D = 4.0


def _rotation_z(rad):
    c, s = math.cos(rad), math.sin(rad)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def _rotation_y(rad):
    c, s = math.cos(rad), math.sin(rad)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def camera_rotation(view) -> np.ndarray:
    """RenderConsumer ctor rotation chain (render.cpp:51-55):
    R = Rz(az) @ Ry(90 - el) @ Rz(-90 + ro), row-major, world = R @ camera."""
    rad = math.radians
    return (
        _rotation_z(rad(view.az))
        @ _rotation_y(rad(90.0 - view.el))
        @ _rotation_z(rad(-90.0 + view.ro))
    )


def compute_scale_az0(lens_type: LensType, fov_deg: float, short_pix: float,
                      res_w: int, res_h: int, rot: np.ndarray) -> tuple:
    """Per-type scale / az0 (lens_proj_build.hpp ComputeScaleAz0)."""
    fov = math.radians(fov_deg)
    scale, az0 = 1.0, 0.0
    if lens_type in (LensType.LINEAR, LensType.GLOBE):
        scale = short_pix / 2.0 / math.tan(fov / 2.0)
    elif lens_type == LensType.FISHEYE_EQUAL_AREA:
        scale = short_pix / 2.0 / math.sqrt(2.0) / math.sin(fov / 4.0)
    elif lens_type == LensType.FISHEYE_EQUIDISTANT:
        scale = short_pix * (math.pi / 2.0) / fov
    elif lens_type == LensType.FISHEYE_STEREOGRAPHIC:
        scale = short_pix / 2.0 / math.tan(fov / 4.0)
    elif lens_type == LensType.FISHEYE_ORTHOGRAPHIC:
        scale = short_pix / 2.0 / math.sin(fov / 2.0)
    elif lens_type == LensType.RECTANGULAR:
        short_res = min(res_w // 2, res_h)
        scale = short_res / math.pi
        ax_z = rot @ np.array([0.0, 0.0, 1.0])
        az0 = math.atan2(ax_z[1], ax_z[0])
    return scale, az0


def dual_fisheye_r_scale(lens_type: LensType, overlap: float) -> tuple:
    """(r_scale, max_abs_dz) for dual-fisheye overlap (projection.cpp:194-204)."""
    if overlap <= 0:
        return 1.0, 0.0
    if lens_type == LensType.DUAL_FISHEYE_EQUAL_AREA:
        return 1.0 / math.sqrt(1.0 + overlap), overlap
    if lens_type == LensType.DUAL_FISHEYE_EQUIDISTANT:
        return (math.pi / 2) / (math.pi / 2 + math.asin(overlap)), overlap
    if lens_type == LensType.DUAL_FISHEYE_STEREOGRAPHIC:
        return 1.0 / math.tan((math.pi / 2 + math.asin(overlap)) / 2.0), overlap
    # Orthographic overlap is deliberately unsupported (render.cpp legacy note).
    return 1.0, 0.0


def make_proj_plan(cfg: RenderConfig) -> ProjPlan:
    rot = camera_rotation(cfg.view)
    short_pix = float(min(cfg.resolution[0], cfg.resolution[1]))
    scale, az0 = compute_scale_az0(cfg.lens.type, cfg.lens.fov, short_pix,
                                   cfg.resolution[0], cfg.resolution[1], rot)
    r_scale, max_abs_dz = 1.0, 0.0
    if cfg.lens.type in (
        LensType.DUAL_FISHEYE_EQUAL_AREA,
        LensType.DUAL_FISHEYE_EQUIDISTANT,
        LensType.DUAL_FISHEYE_STEREOGRAPHIC,
        LensType.DUAL_FISHEYE_ORTHOGRAPHIC,
    ):
        r_scale, max_abs_dz = dual_fisheye_r_scale(cfg.lens.type, cfg.overlap)
    return ProjPlan(
        lens_type=int(cfg.lens.type),
        width=int(cfg.resolution[0]),
        height=int(cfg.resolution[1]),
        visible=int(cfg.visible),
        shift_x=int(cfg.lens_shift[0]),
        shift_y=int(cfg.lens_shift[1]),
        scale=float(scale),
        az0=float(az0),
        r_scale=float(r_scale),
        max_abs_dz=float(max_abs_dz),
        rot=rot.astype(np.float32),
    )


def _fisheye_forward(lens_type: int, dx, dy, dz, r_scale: float):
    """The four fisheye forwards + linear (projection_shared.h:42-96).
    Returns (x, y, valid)."""
    if lens_type in (LensType.FISHEYE_EQUAL_AREA, LensType.DUAL_FISHEYE_EQUAL_AREA):
        k = r_scale / jnp.sqrt(1.0 + jnp.clip(dz, -1.0 + 1e-6, 1.0))
        return k * dx, k * dy, jnp.ones_like(dz, bool)
    rho = jnp.sqrt(dx * dx + dy * dy)
    safe_rho = jnp.maximum(rho, 1e-10)
    theta = jnp.arccos(jnp.clip(dz, -1.0, 1.0))
    if lens_type in (LensType.FISHEYE_EQUIDISTANT, LensType.DUAL_FISHEYE_EQUIDISTANT):
        s = r_scale * theta / (jnp.float32(np.pi / 2) * safe_rho)
        s = jnp.where(rho < 1e-10, 0.0, s)
        return s * dx, s * dy, jnp.ones_like(dz, bool)
    if lens_type in (LensType.FISHEYE_STEREOGRAPHIC, LensType.DUAL_FISHEYE_STEREOGRAPHIC):
        s = r_scale * jnp.tan(theta / 2.0) / safe_rho
        s = jnp.where(rho < 1e-10, 0.0, s)
        return s * dx, s * dy, jnp.ones_like(dz, bool)
    if lens_type in (LensType.FISHEYE_ORTHOGRAPHIC, LensType.DUAL_FISHEYE_ORTHOGRAPHIC):
        return r_scale * dx, r_scale * dy, dz >= 0.0
    raise ValueError(f"not a fisheye lens: {lens_type}")


def _dual_fisheye_pixel(x_norm, y_norm, is_upper, width: int, height: int):
    """DualFisheyeToPixelXY (projection_shared.h:176-196)."""
    short_res = min(width // 2, height)
    r = short_res / 2.0
    cy = height / 2.0
    cx_u = width / 2.0 - r
    cx_l = width / 2.0 + r
    fx = jnp.where(is_upper, -y_norm * r + cx_u, y_norm * r + cx_l)
    fy = x_norm * r + cy
    return jnp.floor(fx + 0.5).astype(jnp.int32), jnp.floor(fy + 0.5).astype(jnp.int32)


def project_continuous(plan: ProjPlan, w_dir: jnp.ndarray):
    """Continuous pixel coordinates (fx, fy, valid) for the single-lens
    family — the differentiable projection surface used by bilinear
    splatting (gradients flow through ray directions into pixel positions,
    which integer binning blocks).
    """
    t = plan.lens_type
    wx, wy, wz = w_dir[..., 0], w_dir[..., 1], w_dir[..., 2]
    rot = jnp.asarray(plan.rot)
    W, H = plan.width, plan.height
    valid = jnp.ones_like(wx, bool)
    if plan.visible == VisibleRange.UPPER:
        valid &= wz <= 0.0
    elif plan.visible == VisibleRange.LOWER:
        valid &= wz >= 0.0
    neg = -w_dir
    c = jnp.einsum("ji,...j->...i", rot, neg, precision="highest")
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    if t == LensType.LINEAR:
        safe_cz = jnp.where(cz > 0, cz, 1.0)
        x, y = cx / safe_cz, cy / safe_cz
        valid &= cz > 0.0
    elif t in (LensType.FISHEYE_EQUAL_AREA, LensType.FISHEYE_EQUIDISTANT,
               LensType.FISHEYE_STEREOGRAPHIC, LensType.FISHEYE_ORTHOGRAPHIC):
        valid &= cz > 0.0
        safe_cz = jnp.where(valid, cz, 1.0)
        x, y, v2 = _fisheye_forward(t, cx, cy, safe_cz, 1.0)
        valid &= v2
    else:
        raise NotImplementedError(
            "project_continuous supports the single-lens family; "
            f"lens type {t} uses the discrete path"
        )
    x = -x
    fx = x * plan.scale + W / 2.0 + 0.5 + plan.shift_x
    fy = y * plan.scale + H / 2.0 + 0.5 + plan.shift_y
    return fx, fy, valid


def splat_bilinear(acc, fx, fy, valid, values, width: int, height: int):
    """Bilinear 4-neighbor scatter-add of `values` [..., C] into a flat
    [H*W, C] accumulator at continuous pixel coords. Differentiable w.r.t.
    fx/fy (the weights) — the soft-binning path for gradient rendering."""
    x0 = jnp.floor(fx - 0.5)
    y0 = jnp.floor(fy - 0.5)
    tx = (fx - 0.5) - x0
    ty = (fy - 0.5) - y0
    for dx, dy, w in (
        (0, 0, (1 - tx) * (1 - ty)),
        (1, 0, tx * (1 - ty)),
        (0, 1, (1 - tx) * ty),
        (1, 1, tx * ty),
    ):
        px = x0.astype(jnp.int32) + dx
        py = y0.astype(jnp.int32) + dy
        ok = valid & (px >= 0) & (px < width) & (py >= 0) & (py < height)
        pix = jnp.where(ok, py * width + px, 0)
        contrib = jnp.where(ok[..., None], values * w[..., None], 0.0)
        acc = acc.at[pix].add(contrib, mode="drop")
    return acc


class PixelHits(NamedTuple):
    """0..2 pixel hits per ray; pix = py * W + px flattened, -1 when invalid.

    main: drives landed weight; overlap: dual-fisheye seam dual-write
    (no intensity contribution — render.cpp:376-390)."""

    main: jnp.ndarray     # [B] int32 flattened pixel or -1
    overlap: jnp.ndarray  # [B] int32 flattened pixel or -1


def project(plan: ProjPlan, w_dir: jnp.ndarray) -> PixelHits:
    """Project world exit directions [B, 3] to pixels
    (ProjectExitToPixel, projection_shared.h:196-375)."""
    return project_components(
        plan, w_dir[..., 0], w_dir[..., 1], w_dir[..., 2]
    )


def project_components(plan: ProjPlan, wx, wy, wz) -> PixelHits:
    """`project` on direction COMPONENT arrays of any (matching) shape — the
    SoA hot path: the camera rotation is applied as scalar-coefficient
    component math (plan.rot is a host constant), so no [N, 3] arrays with a
    3-wide minor dimension ever exist."""
    t = plan.lens_type
    r = plan.rot  # host numpy [3, 3]: scalar coefficients under jit
    W, H = plan.width, plan.height
    no_hit = jnp.full(wx.shape, -1, jnp.int32)

    def cam(wx, wy, wz):
        """Camera frame c = R^T (-w), componentwise."""
        return (
            -(float(r[0, 0]) * wx + float(r[1, 0]) * wy + float(r[2, 0]) * wz),
            -(float(r[0, 1]) * wx + float(r[1, 1]) * wy + float(r[2, 1]) * wz),
            -(float(r[0, 2]) * wx + float(r[1, 2]) * wy + float(r[2, 2]) * wz),
        )

    def in_bounds(px, py, valid):
        ok = valid & (px >= 0) & (px < W) & (py >= 0) & (py < H)
        return jnp.where(ok, py * W + px, -1)

    single = t in (
        LensType.LINEAR,
        LensType.FISHEYE_EQUAL_AREA,
        LensType.FISHEYE_EQUIDISTANT,
        LensType.FISHEYE_STEREOGRAPHIC,
        LensType.FISHEYE_ORTHOGRAPHIC,
    )
    if single:
        valid = jnp.ones_like(wx, bool)
        if plan.visible == VisibleRange.UPPER:
            valid &= wz <= 0.0
        elif plan.visible == VisibleRange.LOWER:
            valid &= wz >= 0.0
        cx, cy, cz = cam(wx, wy, wz)
        if t == LensType.LINEAR:
            safe_cz = jnp.where(cz > 0, cz, 1.0)
            x, y = cx / safe_cz, cy / safe_cz
            valid &= cz > 0.0
        else:
            valid &= cz > 0.0
            x, y, v2 = _fisheye_forward(t, cx, cy, cz, 1.0)
            valid &= v2
        x = -x  # screen handedness (owner decision; projection_shared.h:237)
        px = jnp.floor(x * plan.scale + W / 2.0 + 0.5 + plan.shift_x).astype(jnp.int32)
        py = jnp.floor(y * plan.scale + H / 2.0 + 0.5 + plan.shift_y).astype(jnp.int32)
        return PixelHits(main=in_bounds(px, py, valid), overlap=no_hit)

    if t == LensType.RECTANGULAR:
        sx, sy, sz = -wx, -wy, -wz
        lon = jnp.arctan2(sy, sx) - plan.az0
        lon = jnp.mod(lon + jnp.float32(np.pi), jnp.float32(2 * np.pi)) - jnp.float32(np.pi)
        lat = jnp.arcsin(jnp.clip(sz, -1.0, 1.0))
        raw_x = jnp.floor(lon * plan.scale + W / 2.0 + 0.5).astype(jnp.int32)
        px = jnp.mod(raw_x, W)
        py = jnp.floor(-lat * plan.scale + H / 2.0 + 0.5).astype(jnp.int32)
        valid = (py >= 0) & (py < H)
        return PixelHits(main=jnp.where(valid, py * W + px, -1), overlap=no_hit)

    if t in (
        LensType.DUAL_FISHEYE_EQUAL_AREA,
        LensType.DUAL_FISHEYE_EQUIDISTANT,
        LensType.DUAL_FISHEYE_STEREOGRAPHIC,
        LensType.DUAL_FISHEYE_ORTHOGRAPHIC,
    ):
        sx, sy, sz = -wx, -wy, -wz
        is_upper = sz >= 0.0
        z_hemi = jnp.abs(sz)
        x, y, _ = _fisheye_forward(t, sx, sy, z_hemi, plan.r_scale)
        # Primary write is unconditional (legacy stored the pixel unchecked
        # even for ortho valid=false — projection_shared.h:263-268).
        px, py = _dual_fisheye_pixel(x, y, is_upper, W, H)
        main = in_bounds(px, py, jnp.ones_like(is_upper))
        overlap = no_hit
        if plan.max_abs_dz > 0.0:
            x2, y2, _ = _fisheye_forward(t, sx, sy, -z_hemi, plan.r_scale)
            px2, py2 = _dual_fisheye_pixel(x2, y2, ~is_upper, W, H)
            band = jnp.abs(sz) < plan.max_abs_dz
            overlap = in_bounds(px2, py2, band)
        return PixelHits(main=main, overlap=overlap)

    if t == LensType.GLOBE:
        cx, cy, cz = cam(wx, wy, wz)
        valid = cz < -1.0 / GLOBE_CAMERA_D
        denom = GLOBE_CAMERA_D + cz
        px = jnp.floor(-cx / denom * plan.scale + W / 2.0 + 0.5 + plan.shift_x).astype(jnp.int32)
        py = jnp.floor(cy / denom * plan.scale + H / 2.0 + 0.5 + plan.shift_y).astype(jnp.int32)
        return PixelHits(main=in_bounds(px, py, valid), overlap=no_hit)

    raise ValueError(f"unknown lens type {t}")


# --------------------------------------------------------------------------
# Inverse projection (pixel -> world exit direction)
# --------------------------------------------------------------------------

def _fisheye_inverse(lens_type: int, x, y, r_scale: float):
    """Normalized image plane (x, y) -> unit camera/sky direction (dx, dy,
    dz >= hemisphere) + validity. Inverse of _fisheye_forward; mirrors the
    reference's pure-math inverses (projection.cpp:65-130)."""
    x = x / r_scale
    y = y / r_scale
    r2 = x * x + y * y
    r = jnp.sqrt(r2)
    safe_r = jnp.maximum(r, 1e-10)
    if lens_type in (LensType.FISHEYE_EQUAL_AREA, LensType.DUAL_FISHEYE_EQUAL_AREA):
        dz = 1.0 - r2
        s = jnp.sqrt(jnp.maximum(1.0 + dz, 0.0))
        return x * s, y * s, dz, r2 <= 2.0
    if lens_type in (LensType.FISHEYE_EQUIDISTANT, LensType.DUAL_FISHEYE_EQUIDISTANT):
        theta = r * jnp.float32(np.pi / 2)
        sin_t = jnp.sin(jnp.minimum(theta, jnp.float32(np.pi)))
        return (x / safe_r) * sin_t, (y / safe_r) * sin_t, jnp.cos(theta), theta <= np.pi
    if lens_type in (LensType.FISHEYE_STEREOGRAPHIC, LensType.DUAL_FISHEYE_STEREOGRAPHIC):
        theta = 2.0 * jnp.arctan(r)
        sin_t = jnp.sin(theta)
        return (x / safe_r) * sin_t, (y / safe_r) * sin_t, jnp.cos(theta), jnp.ones_like(r, bool)
    if lens_type in (LensType.FISHEYE_ORTHOGRAPHIC, LensType.DUAL_FISHEYE_ORTHOGRAPHIC):
        dz = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
        return x, y, dz, r2 <= 1.0
    raise ValueError(f"not a fisheye lens: {lens_type}")


def unproject(plan: ProjPlan, px, py):
    """Pixel centers -> world exit directions (the inverse of `project`).

    Returns (w_dir [..., 3], valid). The returned direction is the ray
    PROPAGATION direction whose projection lands on that pixel (so
    project(plan, w_dir).main recovers py * W + px wherever valid). This is
    the display-side lens math the reference keeps in src/core/projection.cpp
    inverses + the GUI inverse-projection shader (projection_shared.h:12-18).
    """
    t = plan.lens_type
    W, H = plan.width, plan.height
    px = jnp.asarray(px, jnp.float32)
    py = jnp.asarray(py, jnp.float32)
    rot = jnp.asarray(plan.rot)

    single = t in (
        LensType.LINEAR,
        LensType.FISHEYE_EQUAL_AREA,
        LensType.FISHEYE_EQUIDISTANT,
        LensType.FISHEYE_STEREOGRAPHIC,
        LensType.FISHEYE_ORTHOGRAPHIC,
    )
    if single:
        x = (px - W / 2.0 - plan.shift_x) / plan.scale
        y = (py - H / 2.0 - plan.shift_y) / plan.scale
        x = -x  # undo screen handedness
        if t == LensType.LINEAR:
            dz = 1.0 / jnp.sqrt(1.0 + x * x + y * y)
            c = jnp.stack([x * dz, y * dz, dz], axis=-1)
            valid = jnp.ones_like(x, bool)
        else:
            cx, cy, cz, valid = _fisheye_inverse(t, x, y, 1.0)
            c = jnp.stack([cx, cy, cz], axis=-1)
            valid = valid & (cz > 0.0)
        w = -jnp.einsum("ij,...j->...i", rot, c, precision="highest")
        return w, valid

    if t == LensType.RECTANGULAR:
        lon = (px - W / 2.0) / plan.scale + plan.az0
        lat = (H / 2.0 - py) / plan.scale
        valid = jnp.abs(lat) <= jnp.float32(np.pi / 2)
        s = jnp.stack(
            [jnp.cos(lat) * jnp.cos(lon), jnp.cos(lat) * jnp.sin(lon), jnp.sin(lat)],
            axis=-1,
        )
        return -s, valid

    if t in (
        LensType.DUAL_FISHEYE_EQUAL_AREA,
        LensType.DUAL_FISHEYE_EQUIDISTANT,
        LensType.DUAL_FISHEYE_STEREOGRAPHIC,
        LensType.DUAL_FISHEYE_ORTHOGRAPHIC,
    ):
        short_res = min(W // 2, H)
        r0 = short_res / 2.0
        cy0 = H / 2.0
        cx_u = W / 2.0 - r0
        cx_l = W / 2.0 + r0
        is_upper = px < W / 2.0
        x_norm = (py - cy0) / r0
        y_norm = jnp.where(is_upper, (cx_u - px) / r0, (px - cx_l) / r0)
        sx, sy, z_hemi, valid = _fisheye_inverse(t, x_norm, y_norm, plan.r_scale)
        sz = jnp.where(is_upper, z_hemi, -z_hemi)
        # Renormalize the horizontal part to the hemisphere height.
        s = jnp.stack([sx, sy, sz], axis=-1)
        s = s / jnp.maximum(jnp.linalg.norm(s, axis=-1, keepdims=True), 1e-10)
        return -s, valid & (z_hemi >= 0.0)

    if t == LensType.GLOBE:
        u = -(px - W / 2.0 - plan.shift_x) / plan.scale
        v = (py - H / 2.0 - plan.shift_y) / plan.scale
        q = u * u + v * v
        D = GLOBE_CAMERA_D
        disc = 1.0 + q * (1.0 - D * D)
        valid = disc >= 0.0
        root = jnp.sqrt(jnp.maximum(disc, 0.0))
        cz = (-q * D - root) / (q + 1.0)  # camera-near surface point
        denom = D + cz
        c = jnp.stack([u * denom, v * denom, cz], axis=-1)
        c = c / jnp.maximum(jnp.linalg.norm(c, axis=-1, keepdims=True), 1e-10)
        w = -jnp.einsum("ij,...j->...i", rot, c, precision="highest")
        return w, valid & (cz < -1.0 / D)

    raise ValueError(f"unknown lens type {t}")

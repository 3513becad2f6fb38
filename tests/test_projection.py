"""Projection tests: center mapping, lens laws, dual-fisheye layout, bounds.

Oracles: closed-form lens mappings (r = f tan/sin/theta laws), the view-center
invariant (a ray arriving FROM the view direction lands at the image center),
and layout conventions (dual-fisheye circles, equirect wrap).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.config.schema import (
    LensParam,
    LensType,
    RenderConfig,
    ViewParam,
    VisibleRange,
)
from ice_halo_sim_jax.core import projection as proj


def make_cfg(lens_type, fov=90.0, res=(800, 600), view=ViewParam(), visible=VisibleRange.FULL,
             shift=(0, 0), overlap=0.0):
    return RenderConfig(
        id=1, lens=LensParam(type=lens_type, fov=fov), resolution=res,
        lens_shift=shift, view=view, visible=visible, overlap=overlap,
    )


def sky_to_ray(az_deg, el_deg):
    """Exit-ray direction for light COMING FROM sky point (az, el):
    the propagation direction is the negative of the sky unit vector."""
    az, el = np.deg2rad(az_deg), np.deg2rad(el_deg)
    sky = np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)], np.float32)
    return -sky


def test_view_center_lands_at_center():
    """A ray from the view direction maps to the image center pixel for every
    centered single-lens type."""
    for lt in [LensType.LINEAR, LensType.FISHEYE_EQUAL_AREA, LensType.FISHEYE_EQUIDISTANT,
               LensType.FISHEYE_STEREOGRAPHIC, LensType.FISHEYE_ORTHOGRAPHIC]:
        view = ViewParam(az=30.0, el=40.0, ro=0.0)
        cfg = make_cfg(lt, fov=100.0, view=view)
        plan = proj.make_proj_plan(cfg)
        d = jnp.asarray(sky_to_ray(30.0, 40.0))[None]
        hits = proj.project(plan, d)
        pix = int(hits.main[0])
        assert pix >= 0, lt
        py, px = divmod(pix, cfg.resolution[0])
        assert abs(px - cfg.resolution[0] // 2) <= 1, lt
        assert abs(py - cfg.resolution[1] // 2) <= 1, lt


def test_linear_tan_law():
    """Linear lens: offset from center = scale * tan(angle)."""
    fov = 90.0
    cfg = make_cfg(LensType.LINEAR, fov=fov, res=(1000, 1000), view=ViewParam(el=90.0))
    plan = proj.make_proj_plan(cfg)
    # Looking straight up; a sky point 20 degrees from zenith toward az=0.
    ang = 20.0
    d = jnp.asarray(sky_to_ray(0.0, 90.0 - ang))[None]
    hits = proj.project(plan, d)
    py, px = divmod(int(hits.main[0]), 1000)
    r = np.hypot(px - 500, py - 500)
    expect = plan.scale * np.tan(np.deg2rad(ang))
    assert r == pytest.approx(expect, abs=1.5)


def test_equidistant_linear_in_angle():
    cfg = make_cfg(LensType.FISHEYE_EQUIDISTANT, fov=180.0, res=(1000, 1000),
                   view=ViewParam(el=90.0))
    plan = proj.make_proj_plan(cfg)
    for ang in (20.0, 40.0, 60.0):
        d = jnp.asarray(sky_to_ray(90.0, 90.0 - ang))[None]
        hits = proj.project(plan, d)
        py, px = divmod(int(hits.main[0]), 1000)
        r = np.hypot(px - 500, py - 500)
        # r = scale * theta / (pi/2) with theta in radians... reference formula:
        # scale_px = scale * theta/(pi/2 * rho) * rho = scale * 2 theta / pi.
        expect = plan.scale * np.deg2rad(ang) / (np.pi / 2)
        assert r == pytest.approx(expect, abs=1.5), ang


def test_equal_area_law():
    """Equal-area: r = 2 f sin(theta/2) => with forward k = 1/sqrt(1+cos) the
    pixel radius is scale * sqrt(2) * sin(theta/2)."""
    cfg = make_cfg(LensType.FISHEYE_EQUAL_AREA, fov=120.0, res=(1200, 1200),
                   view=ViewParam(el=90.0))
    plan = proj.make_proj_plan(cfg)
    for ang in (15.0, 30.0, 55.0):
        d = jnp.asarray(sky_to_ray(45.0, 90.0 - ang))[None]
        hits = proj.project(plan, d)
        py, px = divmod(int(hits.main[0]), 1200)
        r = np.hypot(px - 600, py - 600)
        expect = plan.scale * np.sqrt(2.0) * np.sin(np.deg2rad(ang) / 2)
        assert r == pytest.approx(expect, abs=1.5), ang
    # fov boundary: a point just inside fov/2 lands just inside the short
    # radius; at exactly fov/2 the pixel is one row outside and culled.
    d = jnp.asarray(sky_to_ray(0.0, 90.0 - 59.5))[None]
    hits = proj.project(plan, d)
    assert int(hits.main[0]) >= 0
    py, px = divmod(int(hits.main[0]), 1200)
    expect = plan.scale * np.sqrt(2.0) * np.sin(np.deg2rad(59.5) / 2)
    assert np.hypot(px - 600, py - 600) == pytest.approx(expect, abs=2)
    d = jnp.asarray(sky_to_ray(90.0, 90.0 - 60.05))[None]
    assert int(proj.project(plan, d).main[0]) == -1


def test_visible_range_cull():
    cfg = make_cfg(LensType.FISHEYE_EQUAL_AREA, fov=360.0, res=(800, 800),
                   view=ViewParam(el=90.0), visible=VisibleRange.UPPER)
    plan = proj.make_proj_plan(cfg)
    up = jnp.asarray(sky_to_ray(0.0, 30.0))[None]     # from above horizon: wz < 0
    down = jnp.asarray(sky_to_ray(0.0, -30.0))[None]  # from below horizon: wz > 0
    assert int(proj.project(plan, up).main[0]) >= 0
    assert int(proj.project(plan, down).main[0]) == -1


def test_dual_fisheye_layout_and_overlap():
    cfg = make_cfg(LensType.DUAL_FISHEYE_EQUAL_AREA, fov=120.0, res=(1024, 512), overlap=0.2)
    plan = proj.make_proj_plan(cfg)
    # Upper-hemisphere sky point -> left circle (px < W/2).
    up = jnp.asarray(sky_to_ray(10.0, 45.0))[None]
    hits = proj.project(plan, up)
    py, px = divmod(int(hits.main[0]), 1024)
    assert px < 512
    assert int(hits.overlap[0]) == -1  # |sz| = sin(45) > overlap band
    # Lower-hemisphere -> right circle.
    dn = jnp.asarray(sky_to_ray(10.0, -45.0))[None]
    hits = proj.project(plan, dn)
    py, px = divmod(int(hits.main[0]), 1024)
    assert px >= 512
    # Near-horizon point inside the overlap band gets a dual write into the
    # OPPOSITE circle.
    hz = jnp.asarray(sky_to_ray(10.0, 5.0))[None]  # sin(5 deg) = 0.087 < 0.2
    hits = proj.project(plan, hz)
    py_m, px_m = divmod(int(hits.main[0]), 1024)
    assert px_m < 512
    assert int(hits.overlap[0]) >= 0
    py_o, px_o = divmod(int(hits.overlap[0]), 1024)
    assert px_o >= 512


def test_rectangular_wrap():
    cfg = make_cfg(LensType.RECTANGULAR, res=(1024, 512))
    plan = proj.make_proj_plan(cfg)
    n = 500
    rs = np.random.default_rng(1)
    az = rs.uniform(-720, 720, n)
    el = rs.uniform(-89, 89, n)
    d = jnp.asarray(np.stack([sky_to_ray(a, e) for a, e in zip(az, el)]))
    hits = proj.project(plan, d)
    pix = np.asarray(hits.main)
    assert (pix >= 0).all()  # full-sky: everything lands
    py, px = np.divmod(pix, 1024)
    assert px.min() >= 0 and px.max() < 1024
    # Elevation maps linearly to rows: el=0 -> middle row.
    d0 = jnp.asarray(sky_to_ray(123.0, 0.0))[None]
    py0 = int(proj.project(plan, d0).main[0]) // 1024
    assert abs(py0 - 256) <= 1


def test_globe_cull_and_center():
    """Globe is an OUTSIDE-IN view (projection_shared.h:300-343): the image
    center shows the sky point whose light travels along the view axis, i.e.
    the camera-frame vector c = R^T(-w) = (0,0,-1); sky points aligned with
    the view axis fall on the far side and are culled (cz >= -1/D)."""
    cfg = make_cfg(LensType.GLOBE, fov=60.0, res=(600, 600), view=ViewParam(el=45.0))
    plan = proj.make_proj_plan(cfg)
    view_axis = -sky_to_ray(0.0, 45.0)  # unit vector toward (az 0, el 45)
    center = jnp.asarray(view_axis)[None]  # w aligned with view axis
    pix = int(proj.project(plan, center).main[0])
    assert pix >= 0
    py, px = divmod(pix, 600)
    assert abs(px - 300) <= 1 and abs(py - 300) <= 1
    # Sky point in the view direction sits on the far hemisphere -> culled.
    far = jnp.asarray(sky_to_ray(0.0, 45.0))[None]
    assert int(proj.project(plan, far).main[0]) == -1


def test_lens_shift():
    cfg = make_cfg(LensType.LINEAR, fov=90.0, res=(800, 600), view=ViewParam(el=30.0),
                   shift=(40, -30))
    plan = proj.make_proj_plan(cfg)
    d = jnp.asarray(sky_to_ray(0.0, 30.0))[None]
    py, px = divmod(int(proj.project(plan, d).main[0]), 800)
    assert abs(px - (400 + 40)) <= 1
    assert abs(py - (300 - 30)) <= 1

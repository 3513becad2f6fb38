"""Inverse projection + display overlay tests.

Oracle: unproject(project) round-trip — every valid pixel center must map
to a world direction whose forward projection recovers the same pixel
(the reference validates its lens inverses the same way,
test/golden-analytic/core/test_projection.cpp).
"""

import numpy as np
import pytest

from ice_halo_sim_jax.config.schema import (
    GridLineParam,
    LensParam,
    LensType,
    RenderConfig,
    ViewParam,
    VisibleRange,
)
from ice_halo_sim_jax.core import projection
from ice_halo_sim_jax.engine.overlay import draw_overlays

ALL_LENSES = list(LensType)


@pytest.mark.parametrize("lens_type", ALL_LENSES, ids=[t.name for t in ALL_LENSES])
def test_unproject_project_roundtrip(lens_type):
    cfg = RenderConfig(
        id=1,
        lens=LensParam(type=lens_type,
                       fov=120.0 if lens_type != LensType.RECTANGULAR else 360.0),
        resolution=(64, 32) if lens_type == LensType.RECTANGULAR else (48, 40),
        view=ViewParam(az=30, el=25, ro=10),
        visible=VisibleRange.FULL,
    )
    plan = projection.make_proj_plan(cfg)
    ys, xs = np.mgrid[0 : plan.height, 0 : plan.width]
    w, valid = projection.unproject(
        plan, xs.ravel().astype(np.float32), ys.ravel().astype(np.float32)
    )
    valid = np.asarray(valid)
    assert valid.any(), "no valid pixels"
    w = np.asarray(w)
    # Unit directions wherever valid.
    norms = np.linalg.norm(w[valid], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)

    main = np.asarray(projection.project(plan, w).main)
    want = ys.ravel() * plan.width + xs.ravel()
    exact = (main[valid] == want[valid]).mean()
    assert exact > 0.95, f"round-trip exact rate {exact:.3f}"


def test_unproject_matches_known_direction():
    """Center pixel of an el=90 fisheye looks at the zenith."""
    cfg = RenderConfig(
        id=1,
        lens=LensParam(type=LensType.FISHEYE_EQUAL_AREA, fov=120.0),
        resolution=(64, 64),
        view=ViewParam(az=0, el=90, ro=0),
        visible=VisibleRange.FULL,
    )
    plan = projection.make_proj_plan(cfg)
    w, valid = projection.unproject(plan, np.float32(32.0), np.float32(32.0))
    assert bool(np.asarray(valid))
    # Propagation direction of light FROM the zenith = straight down.
    np.testing.assert_allclose(np.asarray(w), [0.0, 0.0, -1.0], atol=1e-3)


def test_overlay_draws_22_degree_ring():
    cfg = RenderConfig(
        id=1,
        lens=LensParam(type=LensType.FISHEYE_EQUAL_AREA, fov=120.0),
        resolution=(128, 128),
        view=ViewParam(az=0, el=20, ro=0),
        visible=VisibleRange.FULL,
        central_grid=(GridLineParam(value=22.0, width=1.5, opacity=1.0,
                                    color=(1.0, 0.0, 0.0)),),
        celestial_outline=True,
    )
    plan = projection.make_proj_plan(cfg)
    img = np.zeros((128, 128, 3), np.float32)
    draw_overlays(img, cfg, plan, sun_azimuth_deg=0.0, sun_altitude_deg=20.0)
    red = (img[..., 0] > 0.5) & (img[..., 1] < 0.1)
    assert red.sum() > 50, "no 22-degree ring drawn"
    # Ring pixels are ~22 deg from the sun: check against unproject.
    ys, xs = np.nonzero(red)
    w, _ = projection.unproject(plan, xs.astype(np.float32), ys.astype(np.float32))
    s = -np.asarray(w)
    alt = np.deg2rad(20.0)
    sun = np.array([np.cos(alt), 0.0, np.sin(alt)])
    ang = np.degrees(np.arccos(np.clip(s @ sun, -1, 1)))
    assert np.abs(ang - 22.0).max() < 2.0
    # Horizon outline exists (white pixels near elevation 0).
    white = (img[..., 0] > 0.2) & (img[..., 1] > 0.2) & (img[..., 2] > 0.2)
    assert white.sum() > 20, "no celestial outline drawn"


def test_overlay_noop_without_grids():
    cfg = RenderConfig(
        id=1,
        lens=LensParam(type=LensType.FISHEYE_EQUAL_AREA, fov=120.0),
        resolution=(32, 32),
        view=ViewParam(el=45),
        celestial_outline=False,
    )
    plan = projection.make_proj_plan(cfg)
    img = np.zeros((32, 32, 3), np.float32)
    out = draw_overlays(img, cfg, plan, 0.0, 45.0)
    assert (out == 0).all()

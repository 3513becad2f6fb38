"""Raypath-color tests: component masks, per-class Y lanes, compositor."""

import numpy as np
import pytest

from ice_halo_sim_jax.config.loader import load_project
from ice_halo_sim_jax.config.schema import ColorClass
from ice_halo_sim_jax.engine.compositor import (
    composite_color_classes,
    participating_exposure_scale,
    participating_p99,
)
from ice_halo_sim_jax.engine.simulator import Engine


def make_engine(classes, n_batches=4):
    doc = {
        "crystal": [
            {"id": 1, "type": "prism", "shape": {"height": 1.0},
             "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360},
                      "azimuth": {"type": "uniform", "mean": 0, "std": 360},
                      "roll": {"type": "uniform", "mean": 0, "std": 360}}}
        ],
        "filter": [],
        "scene": {
            "light_source": {"type": "sun", "altitude": 90, "azimuth": 0, "diameter": 0.5,
                             "spectrum": [{"wavelength": 550, "weight": 1.0}]},
            "ray_num": 100000, "max_hits": 6,
            "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 100}]}],
        },
        "render": [
            {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 120},
             "resolution": [128, 128], "view": {"elevation": 90}, "visible": "full"}
        ],
        "raypath_color": classes,
    }
    e = Engine(load_project(doc), seed=21, batch_size=1 << 14)
    e.run(n_batches=n_batches)
    return e


def radial_theta(e):
    p = e.proj_plans[0]
    yy, xx = np.mgrid[0 : p.height, 0 : p.width]
    r = np.hypot(xx - p.width / 2, yy - p.height / 2)
    return np.degrees(2 * np.arcsin(np.clip(r / (p.scale * np.sqrt(2)), 0, 1)))


def test_lanes_accumulate_by_predicate():
    """Class 0 tags the [3,5] P-folded 60-deg prism transits; its lane must
    live in the 22-43 deg annulus. Class 1 (whole-crystal) covers everything,
    so its lane equals the full Y image."""
    classes = [
        {"color": [1, 0, 0], "match": [{"layer": 0, "crystal": 1,
                                        "raypath": [3, 5], "symmetry": "P"}]},
        {"color": [0, 0, 1], "match": [{"layer": 0, "crystal": 1}]},
    ]
    e = make_engine(classes)
    lanes = e.lane_y(0)
    assert lanes is not None and lanes.shape[0] == 2
    theta = radial_theta(e)
    lane0, lane1 = lanes
    assert lane0.sum() > 0
    ring_frac = lane0[(theta > 21) & (theta < 45)].sum() / lane0.sum()
    assert ring_frac > 0.98
    # Whole-crystal lane equals the mono Y accumulation.
    xyz = e.raw_xyz(0)
    np.testing.assert_allclose(lane1.sum(), xyz[..., 1].sum(), rtol=1e-4)
    assert lane1.sum() > 3 * lane0.sum()


def test_compositor_modes():
    c, h, w = 2, 4, 4
    lanes = np.zeros((c, h, w), np.float32)
    lanes[0, 0, 0] = 10.0   # class 0 bright at (0,0)
    lanes[1, 0, 0] = 1.0
    lanes[1, 1, 1] = 5.0    # class 1 alone at (1,1)
    classes = (
        ColorClass(name="a", predicates=(), color=(1.0, 0.0, 0.0), z_order=0),
        ColorClass(name="b", predicates=(), color=(0.0, 0.0, 1.0), z_order=1),
    )
    dom = composite_color_classes(lanes, classes, "dominant")
    assert dom is not None
    assert dom[0, 0, 0] > 0 and dom[0, 0, 2] == 0      # class 0 wins (0,0)
    assert dom[1, 1, 2] > 0 and dom[1, 1, 0] == 0      # class 1 owns (1,1)
    add = composite_color_classes(lanes, classes, "additive")
    assert add[0, 0, 0] > 0 and add[0, 0, 2] > 0       # both contribute
    pnt = composite_color_classes(lanes, classes, "painter")
    # Painter: alpha_c = min(lane * A, 1) with A = target_linear / p99;
    # top layer (z_order 0, red) contributes alpha0, blue (1-alpha0)*alpha1.
    p99 = participating_p99(lanes, np.array([True, True]))
    a = participating_exposure_scale(1.0, p99)
    alpha0 = min(10.0 * a, 1.0)
    alpha1 = min(1.0 * a, 1.0)
    assert pnt[0, 0, 0] == pytest.approx(alpha0, rel=1e-4)
    assert pnt[0, 0, 2] == pytest.approx((1 - alpha0) * alpha1, rel=1e-4)


def test_compositor_visibility_and_anchor():
    lanes = np.zeros((2, 2, 2), np.float32)
    lanes[0, 0, 0] = 100.0
    lanes[1, 1, 1] = 1.0
    classes = (
        ColorClass(name="bright", predicates=(), color=(1, 0, 0), visible=False, z_order=0),
        ColorClass(name="dim", predicates=(), color=(0, 1, 0), visible=True, z_order=1),
    )
    # Hiding the bright class shrinks the participating P99 -> the dim class
    # brightens (the task-347 self-anchor behavior).
    out = composite_color_classes(lanes, classes, "dominant")
    # With the bright class hidden, p99 anchors on the dim lane's own value,
    # so its pixel displays at the target-white level (~0.246 linear).
    from ice_halo_sim_jax.engine.compositor import TARGET_LINEAR
    assert out[1, 1, 1] == pytest.approx(TARGET_LINEAR, rel=1e-3)
    assert out[0, 0, 0] == 0.0  # hidden class contributes nothing
    # P99 over participating lanes only.
    assert participating_p99(lanes, np.array([False, True])) == pytest.approx(1.0)
    assert participating_exposure_scale(1.0, 0.0) == 0.0


def test_all_combine():
    """combine=all requires every predicate bit."""
    classes = [
        {"color": [1, 1, 0], "combine": "all",
         "match": [{"layer": 0, "crystal": 1, "raypath": [3, 5], "symmetry": "P"},
                   {"layer": 0, "crystal": 1, "raypath": [1, 2]}]},
    ]
    e = make_engine(classes, n_batches=2)
    lanes = e.lane_y(0)
    # A single exit cannot satisfy two disjoint raypaths -> empty lane.
    assert lanes[0].sum() == 0.0

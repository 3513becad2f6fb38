"""Config loader tests: the reference example config must parse verbatim.

Reference semantics: src/config/crystal_config.cpp, src/core/math.cpp:594-740,
src/config/filter_config.cpp, src/config/config_manager.cpp,
src/config/render_config.cpp.
"""

import json
import math

import pytest

from ice_halo_sim_jax.config import load_project, load_project_file
from ice_halo_sim_jax.config.loader import parse_axis, parse_distribution
from ice_halo_sim_jax.config.schema import (
    ComplexFilter,
    CrystalFilter,
    DirectionFilter,
    DistType,
    EntryExitFilter,
    FilterAction,
    LensType,
    NoneFilter,
    PrismShape,
    PyramidShape,
    RaypathFilter,
    Symmetry,
    VisibleRange,
    miller_to_alpha,
)

EXAMPLE = "/root/reference/examples/config_example.json"


def test_example_config_parses():
    cfg = load_project_file(EXAMPLE)
    assert len(cfg.crystals) == 8
    assert len(cfg.filters) == 7
    assert len(cfg.renders) == 4
    assert cfg.scene.ray_num == 450000000
    assert cfg.scene.max_hits == 7
    assert len(cfg.scene.layers) == 1
    assert cfg.scene.layers[0].prob == 0.0
    assert cfg.scene.layers[0].entries[0].crystal_id == 3
    assert cfg.scene.layers[0].entries[0].proportion == 10.0


def test_crystal_shapes():
    cfg = load_project_file(EXAMPLE)
    c1 = cfg.crystals[1]
    assert isinstance(c1.shape, PrismShape)
    assert c1.shape.height.type == DistType.NO_RANDOM
    assert c1.shape.height.center == pytest.approx(1.2)
    # No axis key -> default fixed orientation, latitude 90 (c-axis vertical).
    assert c1.axis.is_deterministic()
    assert c1.axis.latitude.center == pytest.approx(90.0)

    c2 = cfg.crystals[2]
    assert c2.shape.height.type == DistType.GAUSS
    assert c2.shape.height.center == pytest.approx(1.3)
    assert c2.shape.height.spread == pytest.approx(0.2)
    # axis with zenith only: zenith 90 -> latitude 0; azimuth/roll default
    # uniform full-360.
    assert c2.axis.latitude.type == DistType.NO_RANDOM
    assert c2.axis.latitude.center == pytest.approx(0.0)
    assert c2.axis.azimuth.type == DistType.UNIFORM
    assert c2.axis.azimuth.spread == pytest.approx(360.0)
    assert c2.axis.roll.type == DistType.UNIFORM

    c5 = cfg.crystals[5]
    assert isinstance(c5.shape, PyramidShape)
    assert c5.shape.upper_h.center == pytest.approx(0.1)
    assert c5.shape.lower_h.center == pytest.approx(0.5)
    assert c5.shape.prism_h.center == pytest.approx(1.2)
    # upper_indices [2, 0, 3] -> Miller alpha; lower defaults to 28 deg.
    assert c5.shape.wedge_angle_u == pytest.approx(miller_to_alpha(2, 3))
    assert c5.shape.wedge_angle_l == pytest.approx(28.0)

    c7 = cfg.crystals[7]
    assert c7.axis.latitude.type == DistType.ZIGZAG
    c8 = cfg.crystals[8]
    assert c8.axis.latitude.type == DistType.LAPLACIAN
    assert c8.axis.latitude.center == pytest.approx(0.0)  # zenith 90 -> lat 0


def test_filters():
    cfg = load_project_file(EXAMPLE)
    assert isinstance(cfg.filters[1].param, NoneFilter)
    f2 = cfg.filters[2]
    assert isinstance(f2.param, RaypathFilter)
    assert f2.param.raypath == (3, 1, 5, 7, 4)
    assert f2.symmetry == (Symmetry.P | Symmetry.B | Symmetry.D)
    f3 = cfg.filters[3]
    assert f3.symmetry == Symmetry.P
    f4 = cfg.filters[4]
    assert isinstance(f4.param, EntryExitFilter)
    assert f4.param.entry == 3 and f4.param.exit == 5
    assert f4.action == FilterAction.FILTER_IN
    f5 = cfg.filters[5]
    assert isinstance(f5.param, DirectionFilter)
    assert f5.action == FilterAction.FILTER_OUT
    f6 = cfg.filters[6]
    assert isinstance(f6.param, CrystalFilter)
    assert f6.param.crystal_id == 3
    f7 = cfg.filters[7]
    assert isinstance(f7.param, ComplexFilter)
    assert f7.param.composition == ((1,), (2, 6), (5,))


def test_renders():
    cfg = load_project_file(EXAMPLE)
    r1 = cfg.renders[0]
    assert r1.lens.type == LensType.LINEAR
    # "f": 14 -> fov = 2*atan2(12, 14) (render_config.cpp:73-75)
    assert r1.lens.fov == pytest.approx(math.degrees(math.atan2(12.0, 14.0)) * 2)
    assert r1.resolution == (1920, 1080)
    assert r1.lens_shift == (0, 200)
    assert r1.view.az == pytest.approx(-10.0)
    assert r1.view.el == pytest.approx(20.0)
    assert r1.visible == VisibleRange.UPPER  # default

    r2 = cfg.renders[1]
    assert r2.lens.type == LensType.DUAL_FISHEYE_EQUAL_AREA
    assert r2.lens.fov == pytest.approx(120.0)

    r3 = cfg.renders[2]
    assert r3.visible == VisibleRange.UPPER
    assert r3.ray_color == (1.0, 1.0, 1.0)
    assert r3.opacity == pytest.approx(0.8)
    assert len(r3.central_grid) == 1
    assert r3.central_grid[0].value == pytest.approx(22.0)
    assert r3.celestial_outline is True


def test_spectrum():
    cfg = load_project_file(EXAMPLE)
    assert len(cfg.light.spectrum) == 9
    assert cfg.light.spectrum[0].wl == pytest.approx(450.0)
    assert cfg.light.sun.altitude == pytest.approx(20.0)
    assert cfg.light.sun.diameter == pytest.approx(0.5)


def test_distribution_requires_type():
    with pytest.raises(ValueError):
        parse_distribution({"mean": 1.0})
    d = parse_distribution(20)
    assert d.type == DistType.NO_RANDOM and d.center == 20.0


def test_axis_requires_zenith():
    with pytest.raises(ValueError):
        parse_axis({"azimuth": 10})
    a = parse_axis(None)
    assert a.is_deterministic()


def test_ray_num_infinite():
    doc = json.load(open(EXAMPLE))
    doc["scene"]["ray_num"] = "infinite"
    cfg = load_project(doc)
    assert cfg.scene.ray_num == -1


def test_max_hits_cap():
    doc = json.load(open(EXAMPLE))
    doc["scene"]["max_hits"] = 65
    with pytest.raises(ValueError):
        load_project(doc)


def test_complex_filter_validation():
    doc = json.load(open(EXAMPLE))
    doc["filter"][6]["composition"] = [99]
    with pytest.raises(ValueError):
        load_project(doc)

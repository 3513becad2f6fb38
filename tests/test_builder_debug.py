"""Scene builder, debug ray dump, and logging tests."""

import numpy as np

from ice_halo_sim_jax.config.builder import SceneBuilder, gauss, prism, pyramid, uniform
from ice_halo_sim_jax.config.loader import load_project
from ice_halo_sim_jax.config.serialize import project_to_dict
from ice_halo_sim_jax.engine.debug import dump_rays, format_rays
from ice_halo_sim_jax.engine.simulator import Engine
from ice_halo_sim_jax.utils import log


def _builder():
    return (
        SceneBuilder()
        .add_crystal(1, prism(height=1.2), zenith=uniform(90, 360),
                     azimuth=uniform(0, 360))
        .sun(altitude=25)
        .spectrum_wavelength(550)
        .sim_params(ray_num=65536, max_hits=6)
        .add_scatter_layer([(1, 100.0)])
        .add_render(lens="fisheye_equal_area", fov=120, resolution=(64, 64),
                    elevation=25)
    )


def test_builder_builds_valid_config():
    cfg = _builder().build()
    assert len(cfg.crystals) == 1
    assert cfg.scene.ray_num == 65536
    assert cfg.renders[0].resolution == (64, 64)
    # Round-trips through the serializer like any loaded config.
    assert load_project(project_to_dict(cfg)) == cfg


def test_builder_filters_and_colors():
    b = (
        _builder()
        .add_raypath_filter(2, [3, 5], symmetry="PB")
        .add_filter(3, "entry_exit", entry=1, exit=2)
        .add_complex_filter(4, [[2, 3]])
        .add_color_class("plate", [{"crystal": 1, "raypath": [1, 3, 2]}],
                         color=(1, 0, 0))
        .composite_mode("additive")
    )
    doc = b.to_dict()
    # The scatter layer must reference a filter for it to apply:
    doc["scene"]["scattering"][0]["entries"][0]["filter"] = 4
    cfg = load_project(doc)
    assert len(cfg.filters) == 3
    assert cfg.raypath_color is not None
    assert cfg.raypath_color.composite_mode == "additive"
    # Engine accepts it end-to-end.
    eng = Engine(cfg, seed=5, batch_size=1 << 13)
    eng.run(n_batches=1)


def test_builder_pyramid_and_clone():
    b = _builder()
    b2 = b.clone().add_crystal(
        2, pyramid(upper_h=0.5, prism_h=0.4, upper_indices=(1, 0, 1)),
        zenith=gauss(0, 1),
    )
    assert len(b.to_dict()["crystal"]) == 1     # clone is independent
    assert len(b2.to_dict()["crystal"]) == 2


def test_dump_rays():
    cfg = _builder().build()
    eng = Engine(cfg, seed=5, batch_size=1 << 13)
    rec = dump_rays(eng, n_rays=512)
    assert len(rec.ray_idx) > 0
    assert rec.direction.shape == (len(rec.ray_idx), 3)
    # Exit directions are unit vectors; weights in (0, 1].
    np.testing.assert_allclose(
        np.linalg.norm(rec.direction, axis=-1), 1.0, atol=1e-3
    )
    assert (rec.weight > 0).all() and (rec.weight <= 1.0 + 1e-6).all()
    # Paths: prefix lengths agree with slot index (slot h = h+1 faces).
    assert (rec.path_len == rec.exit_slot + 1).all()
    # Face numbers in the prism legal set.
    faces = rec.path[rec.path > 0]
    assert np.isin(faces, np.arange(1, 9)).all()
    text = format_rays(rec)
    assert "weight" in text and "-" in text


def test_log_callback():
    events = []
    log.set_log_callback(lambda lvl, name, msg: events.append((lvl, name, msg)))
    log.set_log_level("debug")
    try:
        log.get_logger("test").debug("hello %d", 7)
        assert events and events[-1][2] == "hello 7"
        assert events[-1][0] == "debug"
    finally:
        log.set_log_callback(None)
        log.set_log_level("warn")

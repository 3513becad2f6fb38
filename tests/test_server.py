"""Server layer tests: commit/reuse protocol, lifecycle, result frames.

Mirrors the reference server contracts (src/server/server.cpp):
value-equal commit reuses accumulation, appearance-only render change
re-tone-maps without re-simulating, layout change resets and bumps the
generation, ray budget drains to IDLE, infinite budget runs until stopped.
"""

import dataclasses
import time

import numpy as np
import pytest

from ice_halo_sim_jax.config.loader import load_project
from ice_halo_sim_jax.engine.server import ResultFrame, Server, SimState

CFG = {
    "crystal": [
        {
            "id": 1,
            "type": "prism",
            "shape": {"height": 1.0},
            "axis": {
                "zenith": {"type": "uniform", "mean": 90, "std": 360},
                "azimuth": {"type": "uniform", "mean": 0, "std": 360},
            },
        }
    ],
    "filter": [],
    "scene": {
        "light_source": {
            "type": "sun",
            "altitude": 25,
            "spectrum": [{"wavelength": 550, "weight": 1.0}],
        },
        "ray_num": 65536,
        "max_hits": 6,
        "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 1}]}],
    },
    "render": [
        {
            "id": 1,
            "lens": {"type": "fisheye_equal_area", "fov": 120},
            "resolution": [64, 64],
            "view": {"elevation": 25},
        }
    ],
}


@pytest.fixture(scope="module")
def server():
    with Server(seed=9, batch_size=1 << 14) as s:
        yield s


def test_commit_runs_to_idle(server):
    reused = server.commit(CFG)
    assert reused is False
    assert server.wait_idle(timeout=120)
    assert server.state() == SimState.IDLE
    frame = server.acquire_frame()
    assert isinstance(frame, ResultFrame)
    assert frame.is_idle
    assert frame.ray_count >= CFG["scene"]["ray_num"]
    assert frame.images[0].shape == (64, 64, 3)
    assert frame.raw_xyz[0].shape == (64, 64, 3)
    assert float(frame.raw_xyz[0].sum()) > 0


def test_identical_commit_reuses(server):
    server.commit(CFG)
    server.wait_idle(timeout=120)
    gen = server.generation()
    count = server.sim_ray_count()
    assert server.commit(CFG) is True
    assert server.generation() == gen
    assert server.sim_ray_count() == count  # accumulation preserved


def test_appearance_only_commit_keeps_accumulation(server):
    server.commit(CFG)
    server.wait_idle(timeout=120)
    before = server.acquire_frame()
    cfg2 = {**CFG, "render": [dict(CFG["render"][0], background=[0.3, 0.0, 0.0])]}
    assert server.commit(cfg2) is True
    after = server.acquire_frame()
    np.testing.assert_array_equal(before.raw_xyz[0], after.raw_xyz[0])
    assert not np.array_equal(before.images[0], after.images[0])  # re-tone-mapped


def test_layout_change_resets(server):
    server.commit(CFG)
    server.wait_idle(timeout=120)
    gen = server.generation()
    cfg2 = {**CFG, "render": [dict(CFG["render"][0], resolution=[32, 32])]}
    assert server.commit(cfg2) is False
    assert server.generation() == gen + 1
    server.wait_idle(timeout=120)
    frame = server.acquire_frame()
    assert frame.images[0].shape == (32, 32, 3)
    assert frame.generation == gen + 1


def test_infinite_budget_runs_until_stopped(server):
    cfg = {**CFG, "scene": {**CFG["scene"], "ray_num": -1}}
    server.commit(cfg)
    deadline = time.time() + 60
    first = server.sim_ray_count()
    while server.sim_ray_count() <= first and time.time() < deadline:
        time.sleep(0.1)
    assert server.sim_ray_count() > first
    assert server.state() == SimState.RUNNING
    server.stop()
    assert server.wait_idle(timeout=60)
    assert server.state() == SimState.IDLE
    # Results remain readable after stop.
    assert server.acquire_frame().ray_count > 0


def test_typed_config_commit(server):
    cfg = load_project(CFG)
    server.commit(dataclasses.replace(cfg))
    server.wait_idle(timeout=120)
    assert server.acquire_frame().ray_count >= cfg.scene.ray_num


# ---------------------------------------------------------------------------
# Display-time color control + lifecycle surface
# ---------------------------------------------------------------------------

CFG_COLOR = {
    **CFG,
    "scene": {**CFG["scene"], "ray_num": 32768},
    "raypath_color": {
        "mode": "additive",
        "classes": [
            {"name": "all", "match": [{"layer": 0, "crystal": 1}],
             "color": [1.0, 0.2, 0.2]},
            {"name": "parhelion", "match": [
                {"layer": 0, "crystal": 1, "raypath": [3, 5]}],
             "color": [0.2, 1.0, 0.2]},
        ],
    },
}


def test_set_raypath_colors_display_time(server):
    from ice_halo_sim_jax.engine.server import ColorClassDisplay

    server.commit(CFG_COLOR)
    server.wait_idle(timeout=180)
    before = server.acquire_frame()
    assert before.composites[0] is not None
    gen = server.generation()

    displays = [
        ColorClassDisplay(color=(0.1, 0.1, 1.0)),
        ColorClassDisplay(color=(1.0, 1.0, 0.1)),
    ]
    server.set_raypath_colors(displays, z_order=[1, 0], mode="painter")
    after = server.acquire_frame()
    # No re-simulation, no generation bump; composite re-baked.
    assert server.generation() == gen
    np.testing.assert_array_equal(before.raw_xyz[0], after.raw_xyz[0])
    assert not np.array_equal(
        np.asarray(before.composites[0]), np.asarray(after.composites[0])
    )

    with pytest.raises(ValueError):
        server.set_raypath_colors(displays[:1])         # count mismatch
    with pytest.raises(ValueError):
        server.set_raypath_colors(displays, z_order=[0, 0])  # not a permutation
    with pytest.raises(ValueError):
        server.set_raypath_colors(displays, mode="nope")


def test_set_composite_exposure(server):
    server.commit(CFG_COLOR)
    server.wait_idle(timeout=180)
    f0 = server.acquire_frame()
    server.set_composite_exposure(-6.0)
    f1 = server.acquire_frame()
    # 2^-6 exposure dims the composite (raw lanes unchanged).
    assert np.asarray(f1.composites[0]).sum() < np.asarray(f0.composites[0]).sum()
    np.testing.assert_array_equal(f0.raw_xyz[0], f1.raw_xyz[0])
    server.set_composite_exposure(0.0)


def test_color_class_signal(server):
    server.commit(CFG_COLOR)
    server.wait_idle(timeout=180)
    flags = server.color_class_signal()
    assert len(flags) == 2
    assert flags[0] == 1  # whole-crystal class always captures


def test_color_overflow_info(server):
    server.commit(CFG_COLOR)
    info = server.color_overflow_info()
    assert info["component_overflow_count"] == 0
    assert info["component_capacity"] == 32


def test_color_overflow_degrades_not_fails():
    # 33 predicates: one beyond the component-mask budget -> commit succeeds,
    # overflow surfaces through the info call (reference "coloring degraded"
    # contract, LUMICE_GetColorOverflowInfo).
    many = {
        **CFG,
        "scene": {**CFG["scene"], "ray_num": 4096},
        "raypath_color": {
            "classes": [
                {"name": f"c{i}", "match": [
                    {"layer": 0, "crystal": 1, "raypath": [3, 3 + (i % 5)]}],
                 "color": [1, 1, 1]}
                for i in range(33)
            ]
        },
    }
    with Server(seed=3, batch_size=1 << 12) as s:
        s.commit(many)
        info = s.color_overflow_info()
        assert info["component_overflow_count"] == 1


def test_drain_status_and_lifecycle(server):
    server.commit(CFG)
    server.wait_idle(timeout=180)
    ds = server.drain_status()
    assert ds.drained_epoch == ds.current_epoch
    lc = server.lifecycle()
    assert lc["state"] == "idle"
    assert lc["epoch"] == server.generation()


def test_frame_ev_auto_and_landed(server):
    server.commit(CFG)
    server.wait_idle(timeout=180)
    f = server.acquire_frame()
    assert len(f.landed) == 1 and f.landed[0] > 0
    # EV-auto: finite, clamped to [-6, 6], and consistent with the formula.
    from ice_halo_sim_jax.engine import ev_auto as ev
    expect = ev.compute_ev_auto(ev.compute_p99_y(f.raw_xyz[0]), f.landed[0])
    assert f.ev_auto[0] == expect
    assert -6.0 <= f.ev_auto[0] <= 6.0

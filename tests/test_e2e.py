"""End-to-end tests: engine + CLI on small scenes.

Physical oracle: the rendered all-sky image of random-orientation prisms must
show the 22-degree halo — an annulus of enhanced radiance at ~22 deg from the
sun with a dark hole inside (no scattering below minimum deviation).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ice_halo_sim_jax.config.loader import load_project
from ice_halo_sim_jax.engine.simulator import Engine

SMOKE_CFG = {
    "crystal": [
        {
            "id": 1,
            "type": "prism",
            "shape": {"height": 1.0},
            "axis": {
                "zenith": {"type": "uniform", "mean": 90, "std": 360},
                "azimuth": {"type": "uniform", "mean": 0, "std": 360},
                "roll": {"type": "uniform", "mean": 0, "std": 360},
            },
        }
    ],
    "filter": [],
    "scene": {
        "light_source": {
            "type": "sun",
            "altitude": 90,
            "azimuth": 0,
            "diameter": 0.5,
            "spectrum": [{"wavelength": 550, "weight": 1.0}],
        },
        "ray_num": 300000,
        "max_hits": 7,
        "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 100}]}],
    },
    "render": [
        {
            "id": 1,
            "lens": {"type": "fisheye_equal_area", "fov": 120},
            "resolution": [256, 256],
            "view": {"elevation": 90},
            "visible": "full",
        }
    ],
}


@pytest.fixture(scope="module")
def engine():
    cfg = load_project(SMOKE_CFG)
    e = Engine(cfg, seed=5, batch_size=1 << 15)
    e.run(n_batches=8)
    return e


def test_22_halo_annulus(engine):
    """Radial luminance profile around the sun: dark hole inside 20 deg, ring
    peak in [21, 24] deg (sun at zenith, equal-area fisheye)."""
    xyz = engine.raw_xyz(0)
    h, w, _ = xyz.shape
    y = xyz[..., 1]
    yy, xx = np.mgrid[0:h, 0:w]
    # Equal-area: r_pix = scale * sqrt(2) sin(theta/2); invert for theta.
    scale = engine.proj_plans[0].scale
    r_pix = np.hypot(xx - w / 2, yy - h / 2)
    arg = np.clip(r_pix / (scale * np.sqrt(2.0)), 0, 1)
    theta = np.degrees(2 * np.arcsin(arg))
    bins = np.arange(0, 60, 1.0)
    prof = np.zeros(len(bins) - 1)
    for i in range(len(bins) - 1):
        m = (theta >= bins[i]) & (theta < bins[i + 1])
        prof[i] = y[m].mean() if m.any() else 0.0
    # Exclude the direct forward-transmission beam at the sun (theta < 5).
    peak_bin = 5 + int(np.argmax(prof[5:]))
    assert 20 <= bins[peak_bin] <= 24, f"halo peak at {bins[peak_bin]} deg"
    # Dark hole: mean luminance in [10, 18] deg well below the peak.
    hole = prof[10:18].mean()
    assert prof[peak_bin] > 5 * hole


def test_landed_weight_accounting(engine):
    """Landed weight equals the XYZ Y-sum / CMF_Y(550) and is a sane fraction
    of total rays (most exits land in the all-sky view)."""
    from ice_halo_sim_jax.core import color

    landed = float(np.asarray(engine.accum[-1])[0])
    xyz = engine.raw_xyz(0)
    y_cmf = float(np.asarray(color.cmf_lookup(np.asarray([550.0])))[0, 1])
    assert xyz[..., 1].sum() == pytest.approx(landed * y_cmf, rel=1e-3)
    total_rays = engine.stats.rays_traced
    assert 0.5 * total_rays < landed < 1.01 * total_rays


def test_snapshot_images(engine):
    imgs = engine.snapshot()
    assert len(imgs) == 1
    img = imgs[0]
    assert img.shape == (256, 256, 3) and img.dtype == np.uint8
    assert (img.sum(axis=-1) > 0).mean() > 0.2  # plenty of lit sky


def test_cli_renders_png(tmp_path):
    cfg_path = tmp_path / "cfg.json"
    cfg = dict(SMOKE_CFG)
    cfg["scene"] = dict(SMOKE_CFG["scene"], ray_num=20000)
    cfg_path.write_text(json.dumps(cfg))
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "ice_halo_sim_jax.cli", str(cfg_path), "-o", str(tmp_path),
         "--platform", "cpu", "--batch-size", "8192"],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    png = tmp_path / "cfg_render1.png"
    assert png.exists()
    data = png.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(data) > 2000


def test_cli_benchmark_contract(tmp_path):
    """--benchmark emits the reference's [BENCHMARK] line: rate excludes
    setup, rate_basis names the ladder (doc/performance-testing.md:186-237)."""
    import json as json_mod

    cfg_path = tmp_path / "scene.json"
    cfg_path.write_text(json_mod.dumps(SMOKE_CFG))
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "ice_halo_sim_jax.cli", str(cfg_path),
         "--benchmark", "--ray-num", "20000", "--batch-size", "4096",
         "--platform", "cpu"],
        capture_output=True, text=True, timeout=600, cwd="/root/repo",
        env=env,
    )
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-2000:])
    line = next(l for l in out.stdout.splitlines() if l.startswith("[BENCHMARK] "))
    rec = json_mod.loads(line[len("[BENCHMARK] "):])
    assert rec["mode"] == "multi" and rec["workers"] == 1
    assert rec["rays"] == 20480  # 5 batches of 4096
    assert rec["rate_basis"] in ("steady", "active_short")
    assert rec["active_sec"] > 0 and rec["setup_sec"] > 0
    assert rec["rays_per_sec"] == pytest.approx(
        rec["rays"] / rec["active_sec"], rel=0.01)
    assert rec["wall_sec"] >= rec["active_sec"] + rec["setup_sec"] - 0.01

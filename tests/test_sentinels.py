"""Regression sentinels ported from the reference's sentinel suite
(/root/reference/test/regression-sentinel/): each test pins a behavior whose
violation was (or would be) a real bug class.
"""

import numpy as np
import pytest

from ice_halo_sim_jax.config.loader import load_project, load_project_file
from ice_halo_sim_jax.engine.simulator import Engine, largest_remainder_partition

CONFIG_DIR = "/root/reference/test/e2e/configs"


def test_impossible_filter_produces_zero_intensity():
    """MS filter leak (test_ms_filter_leak.py): in Design A, filter-fail
    exits terminate — they neither accumulate NOR continue to the next MS
    layer. An impossible raypath filter [1, 1] (a ray cannot exit through
    basal face 1 twice in a convex prism) must produce a fully black
    accumulation across BOTH layers."""
    cfg = load_project_file(f"{CONFIG_DIR}/ms_filter_leak_impossible.json")
    eng = Engine(cfg, seed=5, batch_size=1 << 14)
    eng.run(n_batches=2)
    xyz = eng.raw_xyz(0)
    assert float(np.abs(xyz).sum()) == 0.0, "impossible filter leaked intensity"
    landed = np.asarray(eng.accum[-1])
    assert float(landed.sum()) == 0.0


def test_stats_dispatch_invariance():
    """Crystal/orientation count dispatch invariance
    (test_crystal_count_dispatch_invariance.py): deterministic counts are
    config constants — independent of batch size and batch count; the
    landed energy per ray is dispatch-invariant to Monte-Carlo noise."""
    doc = {
        "crystal": [
            {
                "id": 1,
                "type": "prism",
                "shape": {"height": 1.0},  # deterministic shape
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
            "scattering": [
                {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 1}]}
            ],
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
    cfg = load_project(doc)
    a = Engine(cfg, seed=5, batch_size=1 << 13)
    a.run(total_rays=1 << 16)  # 8 batches
    b = Engine(cfg, seed=5, batch_size=1 << 16)
    b.run(total_rays=1 << 16)  # 1 batch
    sa, sb = a.drain_stats(), b.drain_stats()
    # Deterministic counts: OVERWRITE rule — config constants.
    assert sa.deterministic_crystal_count == sb.deterministic_crystal_count == 1
    assert sa.deterministic_orientation_count == sb.deterministic_orientation_count == 0
    assert sa.rays_traced == sb.rays_traced == 1 << 16
    # Energy per ray agrees across dispatch grains (MC tolerance).
    la = float(np.asarray(a.accum[-1]).sum()) / sa.rays_traced
    lb = float(np.asarray(b.accum[-1]).sum()) / sb.rays_traced
    assert abs(la - lb) / max(la, 1e-30) < 0.05


def test_max_hits_cap_no_crash():
    """max_hits at the reference cap (kMaxHits = 64, def.hpp:24) traces and
    accumulates finite values (test_max_hits_crash.py sentinel)."""
    doc = {
        "crystal": [
            {
                "id": 1,
                "type": "prism",
                "shape": {"height": 1.0},
                "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360}},
            }
        ],
        "filter": [],
        "scene": {
            "light_source": {
                "type": "sun",
                "altitude": 25,
                "spectrum": [{"wavelength": 550, "weight": 1.0}],
            },
            "ray_num": 4096,
            "max_hits": 64,
            "scattering": [
                {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 1}]}
            ],
        },
        "render": [
            {
                "id": 1,
                "lens": {"type": "fisheye_equal_area", "fov": 120},
                "resolution": [32, 32],
                "view": {"elevation": 25},
            }
        ],
    }
    cfg = load_project(doc)
    eng = Engine(cfg, seed=5, batch_size=4096)
    eng.run(n_batches=1)
    xyz = eng.raw_xyz(0)
    assert np.isfinite(xyz).all()
    assert float(np.asarray(eng.accum[-1]).sum()) > 0
    with pytest.raises(ValueError):
        load_project({**doc, "scene": {**doc["scene"], "max_hits": 65}})


def test_zero_proportion_gets_zero_rays():
    """Zero-proportion scatter entries receive no rays and no shape samples
    (crystal_sample_count_zero_proportion fixture semantics)."""
    assert largest_remainder_partition(1024, [10.0, 0.0]) == [1024, 0]
    assert largest_remainder_partition(1024, [0.0, 0.0]) == [0, 0]
    cfg = load_project_file(f"{CONFIG_DIR}/crystal_sample_count_zero_proportion.json")
    eng = Engine(cfg, seed=5, batch_size=1 << 13)
    for plan in eng.layers:
        for count, entry in zip(plan.setting_counts, cfg.scene.layers[0].entries):
            if entry.proportion == 0:
                assert count == 0
    eng.run(n_batches=1)  # and it traces without error


def test_emit_weight_floor_negligible_mass_honest_accounting():
    """IHT_MIN_EMIT_W drops sub-threshold exits from accumulation only:
    image mass moves by less than the floor's documented bound, the dropped
    mass is accounted (not silently lost), and 0 disables the floor
    exactly."""
    cfg = load_project_file(f"{CONFIG_DIR}/bench_light_single_ms.json")

    def run_with(frac):
        eng = Engine(cfg, seed=11, batch_size=1 << 13)
        eng.min_emit_frac = frac
        eng.emit_floor_mode = "drop"  # this test pins the biased-drop mode
        eng.run(n_batches=1)
        eng.drain_stats()
        return eng

    base = run_with(0.0)
    floored = run_with(1e-3)
    m0 = float(np.asarray(base.raw_xyz(0)).sum())
    m1 = float(np.asarray(floored.raw_xyz(0)).sum())
    assert m0 > 0
    # Mass loss exists but is tiny (probe-measured ~1e-5 relative; allow 1e-3).
    assert 0 <= (m0 - m1) / m0 < 1e-3, (m0, m1)
    # The dropped mass is accounted: floored run's dropped weight grows by
    # at least the image-mass... the landed-weight delta.
    d0 = base.stats.dropped_cont_weight
    d1 = floored.stats.dropped_cont_weight
    landed0 = float(np.asarray(base.accum[-1]).sum())
    landed1 = float(np.asarray(floored.accum[-1]).sum())
    assert d1 > d0
    assert landed0 > landed1 >= 0
    # Conservation: everything the floor removed from landed is in dropped.
    np.testing.assert_allclose(d1 - d0, landed0 - landed1, rtol=1e-3)


def test_emit_floor_rr_is_unbiased_and_conserves_in_expectation():
    """The default emit-floor mode is Russian roulette (IHT_EMIT_FLOOR=rr):
    sub-threshold exits survive with probability w/cut at weight cut, so
    the EXPECTED image equals the floorless one — the default renderer
    output matches reference emission semantics in expectation (the
    reference has no floor). Pins: (a) rr is the
    default mode, (b) per-batch mass accounting stays an exact identity
    (landed + dropped == floorless landed), (c) across seeds the rr image
    mass is centered on the floorless mass, closer than the biased drop's
    systematic loss, (d) rr mass error is well within Monte-Carlo noise."""
    cfg = load_project_file(f"{CONFIG_DIR}/bench_light_single_ms.json")

    def run_with(mode, frac, seed):
        eng = Engine(cfg, seed=seed, batch_size=1 << 13)
        assert eng.emit_floor_mode == "rr"  # (a) default
        eng.emit_floor_mode = mode
        eng.min_emit_frac = frac
        eng.run(n_batches=1)
        eng.drain_stats()
        landed = float(np.asarray(eng.accum[-1]).sum())
        return landed, eng.stats.dropped_cont_weight

    diffs = []
    for seed in (11, 12, 13, 14):
        base, d_base = run_with("rr", 0.0, seed)
        rr, d_rr = run_with("rr", 1e-3, seed)
        # (b) exact accounting identity: the rr delta (either sign) is in
        # dropped weight.
        np.testing.assert_allclose(
            (rr + d_rr) - (base + d_base), 0.0, atol=2e-4 * base
        )
        diffs.append((rr - base) / base)
    # (c)+(d): zero-mean to well within the sub-threshold mass itself; the
    # mean |bias| of rr must be far below the threshold fraction.
    assert abs(float(np.mean(diffs))) < 5e-4, diffs


def test_empty_batch_degenerate_config_no_assert():
    """Degenerate-geometry configs run without crashing and produce finite
    output (repro_empty_batch_assert / degenerate_pipeline_* family)."""
    cfg = load_project_file(f"{CONFIG_DIR}/degenerate_pipeline_gaussian_std050.json")
    eng = Engine(cfg, seed=5, batch_size=1 << 13)
    eng.run(n_batches=1)
    assert np.isfinite(eng.raw_xyz(0)).all()


def test_ms_filter_fail_rays_do_not_leak_to_next_layer():
    """MS filter leak repro scenario (test_ms_filter_leak.py
    test_repro_scenario): layer-1 exits that FAIL the layer's filter must
    not continue into layer 2 either — a 2-layer scene whose first layer
    filters everything out yields an all-black image even though layer 2
    would happily scatter whatever reached it."""
    base = {
        "crystal": [
            {"id": 1, "type": "prism", "shape": {"height": 1.0},
             "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360},
                      "azimuth": {"type": "uniform", "mean": 0, "std": 360},
                      "roll": {"type": "uniform", "mean": 0, "std": 360}}},
        ],
        "filter": [
            # [1, 1]: exit through basal face 1 twice — impossible in a
            # convex prism, so every layer-1 exit fails.
            {"id": 7, "type": "raypath", "action": "filter_in",
             "raypath": [1, 1], "symmetry": "none"},
        ],
        "scene": {
            "light_source": {"type": "sun", "altitude": 30,
                             "spectrum": [{"wavelength": 550, "weight": 1.0}]},
            "ray_num": 30000, "max_hits": 5,
            "scattering": [
                {"prob": 1.0,
                 "entries": [{"crystal": 1, "filter": 7, "proportion": 100}]},
                {"prob": 0.0,
                 "entries": [{"crystal": 1, "proportion": 100}]},
            ],
        },
        "render": [
            {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 150},
             "resolution": [64, 64], "view": {"elevation": 30},
             "visible": "full"},
        ],
    }
    eng = Engine(load_project(base), seed=5, batch_size=1 << 13)
    eng.run(n_batches=2)
    assert float(np.abs(eng.raw_xyz(0)).sum()) == 0.0, (
        "filter-failed rays leaked through the MS boundary")

    # Control: the same scene without the filter is NOT black (the test
    # has teeth).
    import copy

    open_cfg = copy.deepcopy(base)
    open_cfg["scene"]["scattering"][0]["entries"][0].pop("filter")
    eng2 = Engine(load_project(open_cfg), seed=5, batch_size=1 << 13)
    eng2.run(n_batches=2)
    assert float(np.abs(eng2.raw_xyz(0)).sum()) > 0.0


@pytest.mark.slow
def test_cli_benchmark_infinite_terminates(tmp_path):
    """Benchmark-infinite hang sentinel (test_benchmark_infinite_no_hang):
    --benchmark on a ray_num="infinite" config must TERMINATE with a
    drain_aligned [BENCHMARK] line (the reference's bug class: a poll
    loop whose per-poll cost starved drain-window closure)."""
    import json as json_mod
    import os
    import subprocess
    import sys

    cfg = {
        "crystal": [
            {"id": 1, "type": "prism", "shape": {"height": 1.0},
             "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360}}},
        ],
        "filter": [],
        "scene": {
            "light_source": {"type": "sun", "altitude": 40,
                             "spectrum": [{"wavelength": 550, "weight": 1.0}]},
            "ray_num": "infinite", "max_hits": 4,
            "scattering": [
                {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 100}]}
            ],
        },
        "render": [
            {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 120},
             "resolution": [64, 64], "view": {"elevation": 40},
             "visible": "full"},
        ],
    }
    path = tmp_path / "inf.json"
    path.write_text(json_mod.dumps(cfg))
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "ice_halo_sim_jax.cli", str(path),
         "--benchmark", "--batch-size", "4096", "--platform", "cpu"],
        capture_output=True, text=True, timeout=600, cwd="/root/repo",
        env=env,
    )
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-2000:])
    line = next(l for l in out.stdout.splitlines()
                if l.startswith("[BENCHMARK] "))
    rec = json_mod.loads(line[len("[BENCHMARK] "):])
    assert rec["rate_basis"] == "drain_aligned"
    assert rec["rays"] > 0 and rec["rays_per_sec"] > 0


def test_ray_base_hi_epoch_changes_streams():
    """2^32 ray-index stream collision (SplitPcgRayBase,
    trace_backend.hpp:160-190): the batch whose 64-bit ray base is
    2^32 + k must draw DIFFERENT sun/orientation/wavelength streams than
    the batch at base k — pre-fix the u32 wrap silently repeated every
    stream (reference scrum-267.3 silent undersampling). hi == 0 must stay
    bit-identical (the in-range no-op contract)."""
    import jax.numpy as jnp

    doc = {
        "crystal": [
            {"id": 1, "type": "prism", "shape": {"height": 1.3},
             "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360},
                      "azimuth": {"type": "uniform", "mean": 0, "std": 360}}}
        ],
        "filter": [],
        "scene": {
            # Illuminant spectrum: the wavelength POOL draw is itself a
            # per-ray stream and must also decorrelate across hi epochs.
            "light_source": {"type": "sun", "altitude": 25, "spectrum": "D65"},
            "ray_num": 4096, "max_hits": 6,
            "scattering": [{"prob": 0.0,
                            "entries": [{"crystal": 1, "proportion": 1}]}],
        },
        "render": [
            {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 165},
             "resolution": [128, 128], "view": {"elevation": 90},
             "visible": "full"}],
    }
    cfg = load_project(doc)
    eng = Engine(cfg, seed=11, batch_size=1 << 12, accum_method="scatter")

    def rows(hi):
        contribs, _landed, _dw, _segs, _cd, _sm = eng._trace_batch_impl(
            jnp.uint32(12345), jnp.uint32(0), None, jnp.uint32(hi)
        )
        pix, w, wl_idx, _mask = contribs[0]
        return np.asarray(pix), np.asarray(w), np.asarray(wl_idx)

    p0, w0, i0 = rows(0)
    p0b, w0b, i0b = rows(0)
    p1, w1, i1 = rows(1)
    # Determinism: same (lo, hi) -> bit-identical.
    np.testing.assert_array_equal(p0, p0b)
    np.testing.assert_array_equal(w0, w0b)
    # Epoch divergence: same lo, hi=1 -> different streams. Both the
    # landing pixels (sun/orientation draws) and the spectral pool
    # assignment (illuminant wavelength draw) must decorrelate. Rows dead
    # in BOTH epochs compare equal (-1 pixels), so test the live subset.
    live_either = (p0 >= 0) | (p1 >= 0)
    assert live_either.sum() > 100
    assert (p0 != p1)[live_either].mean() > 0.5, (
        "hi epoch did not change ray streams"
    )
    assert (i0 != i1).mean() > 0.3, "hi epoch did not change wl streams"


def test_engine_run_wires_hi_epoch():
    """The engine's run loop itself must pass a nonzero hi word once the
    cumulative ray base crosses 2^32 — grep-level wiring is not enough
    (an earlier hi_epoch_seed shipped with no callers).
    Simulate by pre-advancing batch_counter so the NEXT batch's 64-bit
    base has hi = 1, and assert its image differs from the hi = 0 batch
    with the same lo word."""
    doc = {
        "crystal": [
            {"id": 1, "type": "prism", "shape": {"height": 1.1},
             "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360},
                      "azimuth": {"type": "uniform", "mean": 0, "std": 360}}}
        ],
        "filter": [],
        "scene": {
            "light_source": {"type": "sun", "altitude": 30,
                             "spectrum": [{"wavelength": 550, "weight": 1.0}]},
            "ray_num": 4096, "max_hits": 5,
            "scattering": [{"prob": 0.0,
                            "entries": [{"crystal": 1, "proportion": 1}]}],
        },
        "render": [
            {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 165},
             "resolution": [64, 64], "view": {"elevation": 90},
             "visible": "full"}],
    }
    cfg = load_project(doc)
    B = 1 << 12
    eng = Engine(cfg, seed=3, batch_size=B, accum_method="scatter")
    stride = B * (len(eng.layers) + 1)
    wrap_counter = (1 << 32) // stride  # base64 = 2^32 exactly (lo=0, hi=1)
    assert wrap_counter * stride == 1 << 32

    eng.batch_counter = 0
    eng.run(n_batches=1)
    img_lo = eng.raw_xyz(0).copy()

    eng2 = Engine(cfg, seed=3, batch_size=B, accum_method="scatter")
    eng2.batch_counter = wrap_counter
    eng2.run(n_batches=1)
    img_hi = eng2.raw_xyz(0)

    assert img_lo.sum() > 0 and img_hi.sum() > 0
    assert not np.array_equal(img_lo, img_hi), (
        "batch at ray base 2^32 repeated the base-0 streams"
    )


def test_slot_cap_multilayer_continuation_unaffected(monkeypatch):
    """The exit-slot cap trims ACCUMULATION rows only; continuation to the
    next MS layer is built from the uncapped [H, B] exits. r4 regression:
    the cap's introduction reused slot-capped direction/wl columns in the
    continuation compaction, which crashed (shape mismatch) on any
    multi-layer scene once the calibrated cap fell below max_hits — and
    would have traced layer-1 rays with wrong directions had the shapes
    happened to agree. Pins: (a) a pinned cap < max_hits runs a 2-layer
    scene, (b) continuation statistics (ray segments, which count both
    layers) match the uncapped run exactly, (c) mass conservation holds:
    landed + dropped is invariant under the cap.

    PRECONDITION for (c): the scene's render FOV must cover every exit
    direction (this config's full-sky dual fisheye does). Out-of-FOV exit
    mass lands in NEITHER bucket of the uncapped run, while the capped run
    counts all trimmed slots into dropped_w — so with a partial-FOV
    renderer the symmetric allclose below would flake. If
    the config ever changes, assert total_c >= total_u - tol instead."""
    cfg = load_project_file(f"{CONFIG_DIR}/ms_multi_crystal.json")

    def run_with(cap_env):
        if cap_env is None:
            monkeypatch.delenv("IHT_SLOT_CAP", raising=False)
        else:
            monkeypatch.setenv("IHT_SLOT_CAP", cap_env)
        eng = Engine(cfg, seed=13, batch_size=1 << 13)
        eng.run(n_batches=2)
        eng.drain_stats()
        landed = float(np.asarray(eng.accum[-1]).sum())
        return eng, landed

    capped, landed_c = run_with("1")
    assert capped._slot_cap == 1
    uncapped, landed_u = run_with("off")
    assert uncapped._slot_cap == uncapped.max_hits
    # Continuation is identical: segment counts include layer-1 work.
    assert capped.stats.ray_segments == uncapped.stats.ray_segments
    # The cap moved deep-slot mass from landed into dropped, nothing lost.
    total_c = landed_c + capped.stats.dropped_cont_weight
    total_u = landed_u + uncapped.stats.dropped_cont_weight
    np.testing.assert_allclose(total_c, total_u, rtol=1e-4)
    assert landed_c < landed_u  # cap=1 genuinely drops deep exits here

#!/usr/bin/env python
"""Benchmark: light single-scattering scene, steady-state rays/s on one chip.

Mirrors the reference's canonical `bench_light_single_ms` scene EXACTLY
(test/e2e/configs/bench_light_single_ms.json: single hexagonal prism
h=1.2, zenith uniform 90/360, D65 spectrum, dual_fisheye_equal_area
512x256 with 0.0872 overlap, max_hits 7) and its measurement discipline
(steady-rate window excluding compile/warm-up,
doc/performance-testing.md:76-170). The reference's published numbers for
this scene/resolution: legacy CPU 10.45 M rays/s, CUDA RTX 4060 Ti
130.5 M rays/s (doc/performance-testing.md:403-405).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N}
vs_baseline is against the reference's legacy CPU backend on this scene:
10.45 M rays/s.
"""

import json
import sys
import time

BASELINE_CPU_RAYS_PER_SEC = 10.45e6

# The reference's bench_light_single_ms scene, field for field
# (test/e2e/configs/bench_light_single_ms.json).
BENCH_CFG = {
    "crystal": [
        {
            "id": 1,
            "type": "prism",
            "shape": {"height": 1.2},
            "axis": {
                "zenith": {"type": "uniform", "mean": 90.0, "std": 360.0},
                "azimuth": {"type": "uniform", "mean": 0.0, "std": 360.0},
            },
        }
    ],
    "filter": [],
    "scene": {
        "light_source": {"type": "sun", "altitude": 20.0, "spectrum": "D65"},
        "ray_num": 10000000,
        "max_hits": 7,
        "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 10}]}],
    },
    "render": [
        {
            "id": 1,
            "lens": {"type": "dual_fisheye_equal_area", "fov": 180.0},
            "overlap": 0.0872,
            "resolution": [512, 256],
            "view": {"azimuth": 0.0, "elevation": 0.0, "roll": 0.0},
            "visible": "full",
        }
    ],
}


def main() -> int:
    import jax

    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine
    from ice_halo_sim_jax.utils import env_knobs
    from ice_halo_sim_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    platform = dev.platform

    # The accelerator batch (229,376 rays) is inherited from the earlier
    # accelerator and not yet measured on the H100.
    batch = env_knobs.get(
        "IHT_BATCH_SIZE", 112 * 2048 if platform != "cpu" else 1 << 17
    )
    cfg = load_project(BENCH_CFG)
    engine = Engine(cfg, seed=7, batch_size=batch)

    def hard_sync():
        jax.block_until_ready(engine.accum)

    # Warm-up: compile + first execution of both dispatch paths.
    engine.run(n_batches=1)
    engine.run(n_batches=engine.steps_per_dispatch)
    hard_sync()

    # Steady-state window (doc/performance-testing.md measurement
    # discipline), ~8 s wall cap. Dispatches are issued asynchronously and
    # synced every `sync_every` batches; the rate is (batches issued) /
    # (time to the FINAL sync).
    t0 = time.time()
    batches = 0
    chunk = engine.steps_per_dispatch if platform != "cpu" else 4
    sync_every = 32 * chunk if platform != "cpu" else chunk
    since_sync = 0
    while batches < 4096 and (time.time() - t0) < 8.0:
        engine.run(n_batches=chunk)
        batches += chunk
        since_sync += chunk
        if since_sync >= sync_every:
            hard_sync()
            since_sync = 0
    hard_sync()
    dt = time.time() - t0
    rays = batches * batch
    value = rays / dt

    print(json.dumps({
        "metric": "light_single_ms_rays_per_sec_per_chip",
        "value": value,
        "unit": "rays/s",
        "vs_baseline": value / BASELINE_CPU_RAYS_PER_SEC,
        "rays": rays,
        "seconds": round(dt, 3),
        "batch_size": batch,
        "resolution": [512, 256],
        "platform": platform,
        "device_kind": dev.device_kind,
        "max_hits": 7,
        # Which accumulation fold produced this number.
        "fold": engine.fold_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

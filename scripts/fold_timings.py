#!/usr/bin/env python
"""Time the image fold on the GPU: trace alone against trace + fold, and the
XLA scatter-add fold against the plain-XLA sort fold.

    python scripts/fold_timings.py [--reps 3] [--out timings.jsonl]

Cells: the reference's bench_light_single_ms scene (bench.py) at 512x256 and
2048x1024, and a two-layer multi-scattering scene at 512x256. Each cell runs
``Engine`` with ``accum_method="scatter"`` and ``"sort"`` after warm-up and
calibration, one dispatch (``steps_per_dispatch`` batches) per rep, and a
trace-only program over the same batches (the step's sample -> trace ->
project with the fold left out). Prints one JSON line per cell (and appends
it to --out when given). Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 1 << 20

# Two scattering layers (prob 0.5): plates and columns, the continuation
# buffer between layers carries half the exits into a second crystal.
MS_CFG = {
    "crystal": [
        {"id": 1, "type": "prism", "shape": {"height": 0.3},
         "axis": {"zenith": {"type": "gauss", "mean": 0, "std": 1.0},
                  "azimuth": {"type": "uniform", "mean": 0, "std": 360},
                  "roll": {"type": "uniform", "mean": 0, "std": 360}}},
        {"id": 2, "type": "prism", "shape": {"height": 1.2},
         "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360},
                  "azimuth": {"type": "uniform", "mean": 0, "std": 360}}},
    ],
    "filter": [],
    "scene": {
        "light_source": {"type": "sun", "altitude": 20.0, "spectrum": "D65"},
        "ray_num": 10000000,
        "max_hits": 7,
        "scattering": [
            {"prob": 0.5, "entries": [{"crystal": 1, "proportion": 50},
                                      {"crystal": 2, "proportion": 50}]},
            {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 50},
                                      {"crystal": 2, "proportion": 50}]},
        ],
    },
    "render": None,   # bench.py's render, set below
}


def cells():
    from bench import BENCH_CFG

    light_hi = copy.deepcopy(BENCH_CFG)
    light_hi["render"][0]["resolution"] = [2048, 1024]
    ms = copy.deepcopy(MS_CFG)
    ms["render"] = copy.deepcopy(BENCH_CFG["render"])
    return [("light_512x256", BENCH_CFG), ("light_2048x1024", light_hi),
            ("ms_two_layer_512x256", ms)]


def trace_only_fn(engine):
    """`n` batches of sample -> trace -> project, reduced to a scalar so no
    stage is dead code; the fold is the only part of the step left out."""
    import jax
    import jax.numpy as jnp

    from ice_halo_sim_jax.core import rng

    stride = engine.batch_size * max(1, len(engine.layers) + 1)

    def run(counter0, n):
        def body(i, tot):
            counter = counter0 + jnp.uint32(i)
            lo, hi = rng.mul_u32_split(counter, stride)
            contribs, landed, dropped, segs, _cd, _sm = engine._trace_batch_impl(
                lo, counter, None, hi)
            for pix, w, wl_idx, mask in contribs:
                tot = tot + jnp.sum(w) + jnp.sum(pix).astype(jnp.float32) * 0.0
                tot = tot + jnp.sum((wl_idx ^ mask).astype(jnp.float32)) * 0.0
            return tot + jnp.sum(landed) + dropped + segs.astype(jnp.float32)

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    return jax.jit(run, static_argnums=(1,))


def time_cell(name, cfg_dict, reps):
    import jax
    import jax.numpy as jnp

    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine

    cfg = load_project(cfg_dict)
    out = {"cell": name, "batch": BATCH}
    for method in ("scatter", "sort"):
        eng = Engine(cfg, seed=7, batch_size=BATCH, accum_method=method)
        spd = eng.steps_per_dispatch
        t = time.perf_counter()
        eng.run(n_batches=1)               # compile + calibrate
        eng.run(n_batches=spd)             # compile the calibrated dispatch
        jax.block_until_ready(eng.accum)
        warm = time.perf_counter() - t
        secs = []
        for _ in range(reps):
            t = time.perf_counter()
            eng.run(n_batches=spd)
            jax.block_until_ready(eng.accum)
            secs.append(time.perf_counter() - t)
        rays = spd * eng.batch_size
        out[method] = {
            "fold": eng.fold_kind,
            "warmup_s": warm,
            "dispatch_s": secs,
            "rays_per_s_median": rays / statistics.median(secs),
            "ms_per_batch_median": 1e3 * statistics.median(secs) / spd,
            "slot_cap": eng._slot_cap,
            "keep": eng._compact_keep,
        }
        if method == "scatter":
            fn = trace_only_fn(eng)
            counter = jnp.uint32(eng.batch_counter)
            jax.block_until_ready(fn(counter, spd))
            tsecs = []
            for _ in range(reps):
                t = time.perf_counter()
                jax.block_until_ready(fn(counter, spd))
                tsecs.append(time.perf_counter() - t)
            out["trace_only"] = {
                "dispatch_s": tsecs,
                "ms_per_batch_median": 1e3 * statistics.median(tsecs) / spd,
            }
        del eng
    step_ms = out["scatter"]["ms_per_batch_median"]
    trace_ms = out["trace_only"]["ms_per_batch_median"]
    out["scatter_fold_ms_per_batch"] = step_ms - trace_ms
    out["trace_share_of_scatter_step"] = trace_ms / step_ms
    out["sort_over_scatter_time"] = (
        out["sort"]["ms_per_batch_median"] / step_ms
    )
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=None, help="also append the lines here")
    args = p.parse_args(argv)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"JAX backend is {dev.platform!r}, not 'gpu'")
    from ice_halo_sim_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    for name, cfg in cells():
        rec = time_cell(name, cfg, args.reps)
        rec["device_kind"] = dev.device_kind
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line renderer.

Counterpart of the reference CLI (the reference's src/main.cpp):
load a project JSON, run the simulation, write one PNG per renderer. Progress
prints once per second like the reference's poll loop; `--benchmark` emits a
single [BENCHMARK] JSON line with the steady-state rays/s (the reference's
benchmark discipline, doc/performance-testing.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="JAX ice-halo renderer")
    parser.add_argument("config", help="project JSON file")
    parser.add_argument("-o", "--output", default=".", help="output directory")
    parser.add_argument("--ray-num", type=int, default=None, help="override scene ray_num")
    parser.add_argument("--seed", type=int, default=None,
                        help="RNG seed (default: IHT_SEED env knob, else 1)")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="rays per device step (default: IHT_BATCH_SIZE "
                             "env knob, else a platform heuristic)")
    parser.add_argument("--geom-clock", type=int, default=None,
                        help="rays per sampled crystal shape (default: "
                             "IHT_GEOM_CLOCK env knob, else 32)")
    parser.add_argument("--benchmark", action="store_true",
                        help="measure steady-state rays/s and print [BENCHMARK] JSON")
    parser.add_argument("--draw-overlays", action="store_true",
                        help="rasterize grid lines / celestial outline onto outputs "
                             "(display-time overlays; the reference draws these only "
                             "in its GUI shader)")
    parser.add_argument("--platform", default=None,
                        help="force a JAX platform (e.g. cpu; default: "
                             "IHT_PLATFORM env knob)")
    args = parser.parse_args(argv)

    from ice_halo_sim_jax.utils import env_knobs

    platform = args.platform or env_knobs.get("IHT_PLATFORM")
    if platform:
        os.environ["JAX_PLATFORMS"] = platform
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    from ice_halo_sim_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from ice_halo_sim_jax.config.loader import load_project_file
    from ice_halo_sim_jax.engine.simulator import Engine
    from ice_halo_sim_jax.utils.png import write_png

    cfg = load_project_file(args.config)
    total = args.ray_num if args.ray_num is not None else cfg.scene.ray_num
    if total < 0:
        print("infinite ray_num requires --benchmark or --ray-num", file=sys.stderr)
        if not args.benchmark:
            return 2
        total = None

    seed = args.seed if args.seed is not None else env_knobs.get("IHT_SEED", 1)
    geom_clock = (
        args.geom_clock if args.geom_clock is not None
        else env_knobs.get("IHT_GEOM_CLOCK", 32)
    )
    batch = args.batch_size
    if batch is None:
        batch = env_knobs.get("IHT_BATCH_SIZE")
    if batch is None:
        batch = 1 << 17 if jax.devices()[0].platform == "cpu" else 1 << 20
    if total is not None:
        batch = min(batch, max(4096, total))

    t0 = time.time()
    engine = Engine(cfg, seed=seed, batch_size=batch, geom_clock=geom_clock)

    if args.benchmark:
        # The reference's [BENCHMARK] contract (main.cpp benchmark branch,
        # doc/performance-testing.md:186-237): setup_sec excluded from the
        # rate denominator, rate_basis names which ladder produced it. This
        # engine is single-device like the reference's GPU route, so the
        # dual-pass collapses to ONE steady pass labelled mode="multi"
        # (single/multi parallelism has no referent; workers=1).
        import numpy as np

        def hard_sync():
            np.asarray(engine.accum[-1])

        engine.run(n_batches=1)
        engine.run(n_batches=engine.steps_per_dispatch)
        hard_sync()
        setup_sec = time.time() - t0
        spd = engine.steps_per_dispatch
        infinite = total is None
        t1 = time.time()
        if infinite:
            # Infinite-config ladder: measure exactly N whole drain windows
            # (one dispatch = one device-resident accumulation window; the
            # reference's drain_aligned basis).
            n_windows = 10
            for _ in range(n_windows):
                engine.run(n_batches=spd)
                hard_sync()
            active_sec = time.time() - t1
            rays = n_windows * spd * batch
            rate_basis = "drain_aligned"
        else:
            n_timed = max(1, -(-total // batch))
            engine.run(n_batches=n_timed)
            hard_sync()
            active_sec = time.time() - t1
            rays = n_timed * batch
            rate_basis = "steady" if active_sec >= 1.0 else "active_short"
        wall_sec = time.time() - t0
        print("[BENCHMARK] " + json.dumps({
            "mode": "multi",
            "workers": 1,
            "cores": os.cpu_count(),
            "rays": rays,
            "wall_sec": round(wall_sec, 3),
            "setup_sec": round(setup_sec, 3),
            "active_sec": round(active_sec, 3),
            "rays_per_sec": round(rays / active_sec, 1),
            "rate_basis": rate_basis,
            "batch_size": batch,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
        }))
        return 0

    n_batches = max(1, -(-total // batch))
    done = 0
    last_print = 0.0
    for i in range(n_batches):
        engine.run(n_batches=1)
        done += batch
        now = time.time()
        if now - last_print > 1.0 or i == n_batches - 1:
            print(f"\r{min(done, total)}/{total} rays ({100.0 * min(done, total) / total:.1f}%)",
                  end="", flush=True)
            last_print = now
    jax.block_until_ready(engine.accum)
    dev = jax.devices()[0]
    print(f"\nsimulated {n_batches * batch} rays in {time.time() - t0:.1f}s "
          f"on {dev.platform} ({dev.device_kind})")

    os.makedirs(args.output, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.config))[0]
    for r, (img, rcfg) in enumerate(zip(engine.snapshot(), cfg.renders)):
        if args.draw_overlays:
            from ice_halo_sim_jax.engine.overlay import draw_overlays_u8

            img = draw_overlays_u8(
                img, rcfg, engine.proj_plans[r],
                cfg.light.sun.azimuth, cfg.light.sun.altitude,
            )
        out_path = os.path.join(args.output, f"{stem}_render{rcfg.id}.png")
        write_png(out_path, img)
        print("wrote", out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

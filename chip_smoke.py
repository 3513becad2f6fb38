#!/usr/bin/env python
"""GPU smoke check: the renderer's main path, end to end, on the card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --cards 4  # phase 6 alone: the sharded path on 4 cards

Phases (one process, no subprocess besides ``nvidia-smi``):

  1. Render the reference's ``bench_light_single_ms`` scene (bench.py's
     BENCH_CFG) at its own 10M-ray budget, 512x256, through ``Engine.run``
     and ``snapshot()`` the way ``cli.py`` runs it: finite image with mass,
     landed + dropped weight accounts for the emitted weight, 22-degree
     ring anchor.
  2. Serve the same scene at 2048x1024 through ``Server``: commit, pump,
     ``acquire_frame`` several times; an appearance-only re-commit reuses.
  3. GPU against the plain reference: the same rays on the GPU and on the
     CPU device; the XLA scatter-add fold against a float64 ``np.add.at``
     of one real batch of rows; every matmul of the step at HIGHEST
     precision and no Pallas call (so nothing runs in interpret mode).
  4. Pyramid crystals: all 20 faces survive the pool build on the card, and
     the looped (one-dispatch) compile agrees with per-batch dispatches.
  5. Gradient: the finite-difference check of
     tests/test_gradient.py::test_smooth_transport_gradient_matches_fd_tightly.
  6. (``--cards 4`` only) ``ShardedEngine`` over four cards against the
     sequential single-card oracle.

Any failed check raises: the script then exits non-zero and prints no ok
line. It also refuses to run when JAX finds no GPU. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 7
# Rays the GPU and the CPU device both trace in phase 3.
PARITY_RAYS = 1 << 21
PARITY_BATCH = 1 << 18
# cli.py's and Server's batch on an accelerator.
GPU_BATCH = 1 << 20
GUI_RESOLUTION = [2048, 1024]
# f32 unit roundoff: the worst-case error of summing n terms in any order
# is (n - 1) * U * sum|x| (plus the final rounding).
U32 = 2.0 ** -24

# A random-orientation pyramid scene, sun at the zenith, looking up: the
# pyramid halos are concentric rings around the image centre.
PYRAMID_CFG = {
    "crystal": [
        {
            "id": 1,
            "type": "pyramid",
            "shape": {"upper_h": 0.3, "prism_h": 1.0, "lower_h": 0.3,
                      "upper_wedge_angle": 28.0, "lower_wedge_angle": 28.0},
            "axis": {
                "zenith": {"type": "uniform", "mean": 90, "std": 360},
                "azimuth": {"type": "uniform", "mean": 0, "std": 360},
                "roll": {"type": "uniform", "mean": 0, "std": 360},
            },
        }
    ],
    "filter": [],
    "scene": {
        "light_source": {"type": "sun", "altitude": 90, "azimuth": 0,
                         "diameter": 0.5,
                         "spectrum": [{"wavelength": 550, "weight": 1.0}]},
        "ray_num": 1000000,
        "max_hits": 10,
        "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 100}]}],
    },
    "render": [
        {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 120},
         "resolution": [256, 256], "view": {"elevation": 90}, "visible": "full"}
    ],
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="1: phases 1-5 on one card (default); 4: the sharded "
                        "path on four cards and its oracle, nothing else")
    return p.parse_args(argv)


def check_devices(devices, cards: int) -> None:
    """Refuse anything but `cards` or more GPUs (e.g. JAX fell back to CPU)."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise RuntimeError(f"JAX backend is {platform!r}, not 'gpu'")
    if len(devices) < cards:
        raise RuntimeError(f"need {cards} GPUs, JAX sees {len(devices)}")


def card_info() -> list:
    """`nvidia-smi` name and power limit lines, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln for ln in out.stdout.splitlines() if ln.strip()]


def scene(resolution=None):
    """bench.py's light scene (the reference's bench_light_single_ms), at
    its own 512x256 or at `resolution`."""
    import copy

    from bench import BENCH_CFG

    cfg = copy.deepcopy(BENCH_CFG)
    if resolution is not None:
        cfg["render"][0]["resolution"] = list(resolution)
    return cfg


# --------------------------------------------------------------------------
# Checks shared with the CPU tests
# --------------------------------------------------------------------------

def ring_anchor(engine, cfg) -> tuple:
    """22-degree ring anchor (tests/test_reference_configs.py): mean Y over
    rings of angular radius theta around the sun. Returns (peak_deg,
    inside_19, wall_22)."""
    import numpy as np

    from ice_halo_sim_jax.core import projection

    ysum = engine.raw_xyz(0)[..., 1]
    plan = engine.proj_plans[0]
    alt = np.deg2rad(cfg.light.sun.altitude)
    az = np.deg2rad(cfg.light.sun.azimuth)
    sun = np.array([np.cos(alt) * np.cos(az), np.cos(alt) * np.sin(az),
                    np.sin(alt)])
    e1 = np.cross(sun, [0.0, 0.0, 1.0])
    e1 = e1 / np.linalg.norm(e1) if np.linalg.norm(e1) > 1e-6 else np.array([0.0, 1.0, 0.0])
    e2 = np.cross(sun, e1)

    def ring_mean(theta_deg):
        th = np.deg2rad(theta_deg)
        phis = np.linspace(0, 2 * np.pi, 73)[:-1]
        p = (np.cos(th) * sun[None, :]
             + np.sin(th) * (np.cos(phis)[:, None] * e1 + np.sin(phis)[:, None] * e2))
        pix = np.asarray(projection.project(plan, (-p).astype(np.float32)).main)
        vals = []
        for q in pix[pix >= 0]:
            r, c = divmod(int(q), plan.width)
            vals.append(ysum[max(0, r - 1): r + 2, max(0, c - 1): c + 2].mean())
        return float(np.mean(vals))

    thetas = np.arange(6.0, 41.0, 1.0)
    means = np.array([ring_mean(t) for t in thetas])
    return float(thetas[means.argmax()]), ring_mean(19.0), ring_mean(22.0)


def assert_ring_anchor(engine, cfg) -> tuple:
    peak, inside, wall = ring_anchor(engine, cfg)
    assert 21.0 <= peak <= 25.0, f"22-degree ring peak at {peak} deg"
    assert wall > 5.0 * max(inside, 1e-30), (
        f"no minimum-deviation wall: 19 deg {inside}, 22 deg {wall}")
    return peak, inside, wall


def scatter_vs_add_at(pix, vals, n_pixels: int) -> dict:
    """The XLA scatter-add fold (core/accum.scatter_accumulate) against a
    float64 np.add.at of the same rows, on the default device.

    Tolerance: float32 atomics add in an order that varies from run to run;
    for any order the error of a pixel that receives n rows with magnitude
    sum S is at most (n - 1) * 2^-24 * S, plus the final rounding, so the
    bound is (n + 1) * 2^-24 * S. Every pixel must be within it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ice_halo_sim_jax.core import accum

    pix = np.asarray(pix)
    vals = np.asarray(vals, np.float32)
    acc0 = jnp.zeros((n_pixels, vals.shape[1]), jnp.float32)
    got = np.asarray(
        jax.jit(accum.scatter_accumulate)(acc0, jnp.asarray(pix), jnp.asarray(vals)),
        np.float64,
    )
    ok = (pix >= 0) & (pix < n_pixels)
    ref = np.zeros((n_pixels, vals.shape[1]), np.float64)
    np.add.at(ref, pix[ok], vals[ok].astype(np.float64))
    mag = np.zeros_like(ref)
    np.add.at(mag, pix[ok], np.abs(vals[ok]).astype(np.float64))
    n = np.bincount(pix[ok], minlength=n_pixels)[:, None]
    bound = (n + 1) * U32 * mag
    err = np.abs(got - ref)
    worst = float(np.max(err / np.maximum(bound, 1e-300)))
    assert (err <= bound).all(), f"scatter fold off by {worst:.3f}x its bound"
    return {
        "rows": int(ok.sum()),
        "max_rows_per_pixel": int(n.max()),
        "worst_err_over_bound": worst,
        "mass_rel_err": float(abs(got.sum() - ref.sum()) / max(ref.sum(), 1e-300)),
    }


def _walk_eqns(jaxpr):
    """Every equation of a jaxpr, descending into cond/while/jit bodies."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if hasattr(sub, "consts") and hasattr(sub, "jaxpr"):
                    yield from _walk_eqns(sub.jaxpr)        # ClosedJaxpr
                elif hasattr(sub, "eqns"):
                    yield from _walk_eqns(sub)              # Jaxpr


def step_matmuls(engine) -> dict:
    """Trace ``Engine._step_impl`` and report every dot_general's precision
    and whether any Pallas call is left in the step."""
    import jax

    closed = jax.make_jaxpr(engine._step_impl)(
        engine.accum, jax.numpy.uint32(0), jax.numpy.uint32(0)
    )
    precisions, n_pallas = [], 0
    for eqn in _walk_eqns(closed.jaxpr):
        if eqn.primitive.name == "dot_general":
            precisions.append(str(eqn.params.get("precision")))
        elif "pallas" in eqn.primitive.name:
            n_pallas += 1
    return {"dot_general": precisions, "pallas_calls": n_pallas}


def assert_highest(report: dict) -> None:
    bad = [p for p in report["dot_general"] if "HIGHEST" not in p]
    assert not bad, f"matmuls below HIGHEST precision: {bad}"
    assert report["pallas_calls"] == 0, "a Pallas call is left in the step"


def pyramid_checks(cfg, batch: int, n_batches: int) -> dict:
    """Pool faces on the default device, and the looped compile (one
    dispatch of `n_batches`) against per-batch dispatches of the same
    batches. The slot cap is off so neither run recalibrates mid-way."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ice_halo_sim_jax.engine.simulator import Engine

    os.environ["IHT_SLOT_CAP"] = "off"
    try:
        engine = Engine(cfg, seed=3, batch_size=batch)
        single = Engine(cfg, seed=3, batch_size=batch)
    finally:
        del os.environ["IHT_SLOT_CAP"]
    pool = jax.jit(
        lambda: engine._sample_layer_pool(0, engine.layers[0], jnp.uint32(0))
    )()
    present = np.asarray(pool.face_present)
    assert present.all(), (
        f"pyramid pool dropped faces: {present.sum(axis=-1).min()} of "
        f"{present.shape[-1]} present")
    engine.steps_per_dispatch = n_batches
    engine.run(n_batches=n_batches)            # ONE multi-batch dispatch
    looped = engine.raw_xyz(0).astype(np.float64)
    single.steps_per_dispatch = 1
    single.run(n_batches=n_batches)            # n_batches single dispatches
    stepped = single.raw_xyz(0).astype(np.float64)
    rel = float(np.abs(looped - stepped).sum() / max(stepped.sum(), 1e-30))
    assert rel < 1e-4, f"looped vs per-batch pyramid images differ: {rel:.2e}"
    h, w, _ = looped.shape
    yy, xx = np.mgrid[0:h, 0:w]
    scale = engine.proj_plans[0].scale
    r_pix = np.hypot(xx - w / 2, yy - h / 2)
    theta = np.degrees(2 * np.arcsin(np.clip(r_pix / (scale * np.sqrt(2.0)), 0, 1)))
    y = looped[..., 1]
    near = float(y[theta < 2.0].sum() / y.sum())
    ring = float(y[(theta >= 20.0) & (theta < 25.0)].sum() / y.sum())
    assert near < 0.4, f"{100 * near:.1f}% of mass within 2 deg of the sun"
    assert ring > 0.05, f"20-25 deg band carries only {100 * ring:.1f}% of mass"
    return {"faces": int(present.shape[-1]), "looped_vs_stepped_l1": rel,
            "near_sun_frac": near, "ring_20_25_frac": ring}


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_render() -> None:
    import jax
    import numpy as np

    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine

    cfg = load_project(scene())
    total = cfg.scene.ray_num
    batch = min(GPU_BATCH, max(4096, total))
    n_batches = max(1, -(-total // batch))
    engine = Engine(cfg, seed=SEED, batch_size=batch)
    times = []
    for _ in range(n_batches):          # cli.py's render loop
        t = time.perf_counter()
        engine.run(n_batches=1)
        jax.block_until_ready(engine.accum)
        times.append(time.perf_counter() - t)
    steady = times[2:]
    rate = len(steady) * batch / sum(steady)
    compile_s = times[0] + times[1] - 2 * float(np.median(steady))
    images = engine.snapshot()
    xyz = engine.raw_xyz(0)
    w, h = cfg.renders[0].resolution
    assert images[0].shape == (h, w, 3), images[0].shape
    assert np.isfinite(xyz).all(), "non-finite image"
    assert xyz.sum() > 0, "empty image"
    stats = engine.drain_stats()
    landed = float(np.asarray(engine.accum[-1]).sum())

    # The same rays with no emit floor and no slot cap: every exit lands
    # (full-sky view), so its landed weight is the emitted weight.
    os.environ["IHT_MIN_EMIT_W"] = "0"
    os.environ["IHT_SLOT_CAP"] = "off"
    try:
        ref = Engine(cfg, seed=SEED, batch_size=batch)
    finally:
        del os.environ["IHT_MIN_EMIT_W"], os.environ["IHT_SLOT_CAP"]
    ref.run(n_batches=n_batches)
    emitted = float(np.asarray(ref.accum[-1]).sum())
    acct = abs(landed + stats.dropped_cont_weight - emitted) / emitted
    assert acct < 1e-4, f"landed + dropped misses emitted weight by {acct:.2e}"
    peak, inside, wall = assert_ring_anchor(engine, cfg)
    log(f"phase 1 render: {n_batches} x {batch} rays at {w}x{h}, "
        f"{rate:.6g} rays/s steady, compile ~{compile_s:.1f} s "
        f"(first batches {times[0]:.2f} s, {times[1]:.2f} s), fold "
        f"{engine.fold_kind}, slot cap {engine._slot_cap}/{engine.max_hits}")
    log(f"phase 1 checks: mass {xyz.sum():.6g}, (landed + dropped - emitted)"
        f"/emitted {acct:.2e}, ring peak {peak} deg, 19 deg {inside:.4g} vs "
        f"22 deg {wall:.4g}: OK")


def phase_server() -> None:
    from ice_halo_sim_jax.engine.server import Server

    cfg = scene(GUI_RESOLUTION)
    with Server(seed=SEED) as srv:
        t0 = time.perf_counter()
        assert srv.commit(cfg) is False
        first = None
        while first is None or first.ray_count == 0:
            time.sleep(0.05)
            first = srv.acquire_frame()
            if time.perf_counter() - t0 > 600:
                raise TimeoutError("no frame with rays within 600 s")
        ttff = time.perf_counter() - t0
        gen = first.generation
        counts = [first.ray_count]
        for _ in range(3):
            time.sleep(0.2)
            fr = srv.acquire_frame()
            assert fr.generation == gen
            assert fr.images[0].shape == (GUI_RESOLUTION[1], GUI_RESOLUTION[0], 3)
            counts.append(fr.ray_count)
        assert counts == sorted(counts), counts
        look = scene(GUI_RESOLUTION)
        look["render"][0]["background"] = [0.1, 0.1, 0.2]
        assert srv.commit(look) is True, "appearance-only commit did not reuse"
        assert srv.generation() == gen
        assert srv.wait_idle(timeout=600), "server did not drain its budget"
        last = srv.acquire_frame()
        assert last.ray_count >= cfg["scene"]["ray_num"]
        import numpy as np

        assert np.isfinite(last.raw_xyz[0]).all() and last.raw_xyz[0].sum() > 0
    log(f"phase 2 server at {GUI_RESOLUTION[0]}x{GUI_RESOLUTION[1]}: time to "
        f"first frame {ttff:.2f} s, frames at rays {counts}, appearance "
        f"re-commit reused, drained {last.ray_count} rays: OK")


def phase_reference() -> None:
    import jax
    import numpy as np

    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine

    cfg = load_project(scene())

    def render(device, seed):
        with jax.default_device(device):
            eng = Engine(cfg, seed=seed, batch_size=PARITY_BATCH)
            eng.run(total_rays=PARITY_RAYS)
            return eng.raw_xyz(0).astype(np.float64)

    cpu = jax.devices("cpu")[0]
    gpu_img = render(jax.devices()[0], SEED)
    cpu_img = render(cpu, SEED)
    cpu_other = render(cpu, SEED + 1)

    def l1(a, b):
        return float(np.abs(a - b).sum() / np.abs(b).sum())

    l1_dev, l1_seed = l1(gpu_img, cpu_img), l1(cpu_other, cpu_img)
    mass = abs(gpu_img.sum() - cpu_img.sum()) / cpu_img.sum()
    assert l1_dev < 0.1 * l1_seed, (l1_dev, l1_seed)
    # Same rays on both devices: only transcendental-function ulps and
    # summation order differ, so the masses agree far inside 1e-3.
    assert mass < 1e-3, f"GPU vs CPU image mass differs by {mass:.2e}"
    log(f"phase 3 GPU vs CPU ({PARITY_RAYS} rays, seed {SEED}): L1 "
        f"{l1_dev:.3e} vs cross-seed CPU L1 {l1_seed:.3e} (ratio "
        f"{l1_dev / l1_seed:.3e}, bound 0.1), mass rel diff {mass:.2e} "
        f"(bound 1e-3): OK")

    eng = Engine(load_project(scene(GUI_RESOLUTION)), seed=SEED,
                 batch_size=PARITY_BATCH)
    contribs = jax.jit(eng._trace_batch_impl)(jax.numpy.uint32(0),
                                              jax.numpy.uint32(0))[0]
    pix, w, wl_idx, mask = contribs[0]
    vals = jax.jit(eng._expand_vals)(w, wl_idx, mask, jax.numpy.uint32(0))
    rep = scatter_vs_add_at(pix, vals, GUI_RESOLUTION[0] * GUI_RESOLUTION[1])
    log(f"phase 3 scatter fold vs float64 np.add.at at "
        f"{GUI_RESOLUTION[0]}x{GUI_RESOLUTION[1]}x3: {rep}: OK")

    report = step_matmuls(eng)
    assert_highest(report)
    log(f"phase 3 precision: jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision}; the step's "
        f"{len(report['dot_general'])} dot_general(s) all HIGHEST; 0 Pallas "
        f"calls: OK")


def phase_pyramid() -> None:
    from ice_halo_sim_jax.config.loader import load_project

    rep = pyramid_checks(load_project(PYRAMID_CFG), batch=1 << 16, n_batches=4)
    log(f"phase 4 pyramid: {rep}: OK")


def phase_gradient() -> None:
    import importlib.util

    # Loaded by path: an installed package may also be named `tests`.
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_gradient.py")
    spec = importlib.util.spec_from_file_location("_iht_test_gradient", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.test_smooth_transport_gradient_matches_fd_tightly()
    log("phase 5 gradient: autodiff vs centered FD within 2.5% (N=512, "
        "eps=1e-3): OK")


def phase_sharded() -> None:
    import jax
    import numpy as np

    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine
    from ice_halo_sim_jax.parallel.sharding import ShardedEngine, make_mesh

    n_dev, B, n_check, n_timed = 4, GPU_BATCH, 2, 8
    cfg = load_project(scene(GUI_RESOLUTION))
    se = ShardedEngine(cfg, make_mesh(jax.devices()[:n_dev]), seed=SEED,
                       per_device_batch=B)
    se.run(n_batches=n_check)
    got = se.raw_xyz(0).astype(np.float64)

    # Oracle: one engine on one card stepping each device's ray bases
    # (tests/test_sharding.py), pre-calibrated like the inner engine, with
    # one accumulator per device summed at the end like the drain.
    e = Engine(cfg, seed=SEED, batch_size=B)
    e.run(n_batches=1)
    span = B * (len(e.layers) + 1)
    p = e.proj_plans[0]
    want = np.zeros((p.height * p.width, 3), np.float64)
    for dev in range(n_dev):
        e.reset()
        acc = e.accum
        for counter in range(n_check):
            base = (counter * n_dev * span + dev * span) & 0xFFFFFFFF
            acc = e._step(acc, np.uint32(base), np.uint32(counter),
                          e._compact_keep, e._plan_version)[0]
        want += np.asarray(acc[0][:, :3], np.float64)
    want = want.reshape(p.height, p.width, 3)
    # Tolerance: float32 atomics add each card's rows in an order that
    # varies from run to run, and the hottest pixels (the sun) take ~1e5
    # rows a batch, so their totals agree to ~1e-4 relative, not bit for
    # bit; rtol 1e-3 leaves a 10x margin. Total mass must agree to 1e-5.
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6 * want.max())
    mass = abs(got.sum() - want.sum()) / want.sum()
    assert mass < 1e-5, f"sharded vs oracle mass differs by {mass:.2e}"

    jax.block_until_ready(se.accum)
    t = time.perf_counter()
    se.run(n_batches=n_timed)
    jax.block_until_ready(se.accum)
    dt = time.perf_counter() - t
    t = time.perf_counter()
    jax.block_until_ready(se.drained_accum())
    drain = time.perf_counter() - t
    rate = n_timed * n_dev * B / dt
    err = float(np.max(np.abs(got - want) / np.maximum(want, 1e-6 * want.max())))
    log(f"phase 6 sharded {n_dev} cards at {GUI_RESOLUTION[0]}x"
        f"{GUI_RESOLUTION[1]}: matches the sequential oracle (max pixel rel "
        f"diff {err:.2e}, bound 1e-3; mass rel diff {mass:.2e}); "
        f"{rate:.6g} rays/s total, {rate / n_dev:.6g} rays/s per card, "
        f"drain {1e3 * drain:.3f} ms: OK")


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    devices = jax.devices()
    check_devices(devices, args.cards)
    from ice_halo_sim_jax.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    t0 = time.perf_counter()
    log(f"devices: {len(devices)} x {devices[0].device_kind}; compile cache "
        f"{cache}")
    if args.cards == 4:
        phase_sharded()
    else:
        for phase in (phase_render, phase_server, phase_reference,
                      phase_pyramid, phase_gradient):
            t = time.perf_counter()
            phase()
            log(f"{phase.__name__} took {time.perf_counter() - t:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    for line in card_info():
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

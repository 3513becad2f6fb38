"""Reference-image parity battery.

The reference repo's committed e2e images are git-lfs pointers here (zero
egress), so the TRUE oracle is the reference CLI itself, built offline by
tools/ref_oracle/build.sh. This script renders scenes with BOTH renderers
and scores PSNR between the u8 sRGB outputs, using the reference's own
methodology (test/e2e-correctness/test_smoke.py: PSNR floors calibrated
from run-to-run variation minus margin).

Emit floor: by default our engine runs with IHT_MIN_EMIT_W=0 so the
comparison is against reference emission semantics; --floor default keeps
the engine's own defaults (unbiased Russian-roulette floor) to prove the
DEFAULT output passes the same floors.

Usage:
  python scripts/parity_ref.py [--scenes halo_22 cza ...] [--rays N]
      [--out DIR] [--self-psnr]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
ORACLE = os.path.join(REPO, "tools/ref_oracle/build/lumice_ref")
CONFIG_DIR = "/root/reference/test/e2e/configs"

# Scenes with committed PSNR floors in the reference's test_smoke.py
# (threshold = measured run-to-run PSNR - 3 dB). Same floors apply to us:
# if our renderer differs from the reference CLI by no more than the
# reference differs from itself across runs, the images are equivalent.
REF_THRESHOLDS = {
    "halo_22": 26.5,
    "cza": 41.0,
    "color": 35.0,
    "parhelion": 34.5,
    "pyramid": 28.5,
    "filters": 29.0,
    "multi_scatter": 26.5,
    "orthographic_180": 19.5,
    "ms_multi_crystal": 20.0,
    "multi_lens": 33.5,       # min over the 3 renders' floors: 33.5/34.5/40.3
    "dual_fisheye_ref": 25.8,
    "render_opts": 30.0,
}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def read_images(d):
    from PIL import Image

    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith("img_") or f.endswith(".png"):
            out[f] = np.asarray(Image.open(os.path.join(d, f)).convert("RGB"))
    return out


def run_oracle(scene: str, out_dir: str, rays=None, seed=None) -> float:
    os.makedirs(out_dir, exist_ok=True)
    cfg_path = f"{CONFIG_DIR}/{scene}.json"
    if rays is not None:
        cfg = json.load(open(cfg_path))
        cfg["scene"]["ray_num"] = int(rays)
        cfg_path = os.path.join(out_dir, "cfg.json")
        json.dump(cfg, open(cfg_path, "w"))
    t0 = time.time()
    # The oracle CLI has no seed flag; each run draws fresh entropy, so
    # two runs ARE an independent-seed pair (what self-PSNR needs).
    args = [ORACLE, "-f", cfg_path, "-o", out_dir]
    r = subprocess.run(args, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"oracle failed on {scene}: {r.stderr[-2000:]}")
    return time.time() - t0


def run_ours(scene: str, out_dir: str, rays=None, seed=1, batch=None) -> float:
    os.makedirs(out_dir, exist_ok=True)
    import jax

    from ice_halo_sim_jax.config.loader import load_project_file
    from ice_halo_sim_jax.engine.simulator import Engine
    from ice_halo_sim_jax.utils.png import write_png

    cfg = load_project_file(f"{CONFIG_DIR}/{scene}.json")
    total = int(rays if rays is not None else cfg.scene.ray_num)
    if batch is None:
        batch = 1 << 17 if jax.devices()[0].platform == "cpu" else 1 << 19
    batch = min(batch, max(4096, total))
    t0 = time.time()
    eng = Engine(cfg, seed=seed, batch_size=batch)
    eng.run(total_rays=total)
    for r, img in enumerate(eng.snapshot()):
        write_png(os.path.join(out_dir, f"ours_{r + 1:02d}.png"), img)
    return time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="*", default=list(REF_THRESHOLDS))
    ap.add_argument("--rays", type=int, default=None)
    ap.add_argument("--out", default="/tmp/parity_ref")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--self-psnr", action="store_true",
                    help="also run the oracle twice (seeds 1, 2) to measure "
                         "its own run-to-run PSNR on this machine")
    ap.add_argument("--floor", default="0",
                    help="IHT_MIN_EMIT_W for our engine: '0' (reference "
                         "emission semantics, the strict-parity default) or "
                         "'default' to run the engine's own defaults (the "
                         "unbiased rr floor) — the r5 proof that the "
                         "DEFAULT renderer output passes the floors")
    args = ap.parse_args(argv)

    if args.floor != "default":
        os.environ["IHT_MIN_EMIT_W"] = args.floor
    results = []
    for scene in args.scenes:
        d_ref = os.path.join(args.out, scene, "ref")
        d_ours = os.path.join(args.out, scene, "ours")
        t_ref = run_oracle(scene, d_ref, rays=args.rays)
        t_ours = run_ours(scene, d_ours, rays=args.rays, seed=args.seed)
        ref_imgs = read_images(d_ref)
        our_imgs = read_images(d_ours)
        ref_keys = sorted(k for k in ref_imgs if k.startswith("img_"))
        our_keys = sorted(k for k in our_imgs if k.startswith("ours_"))
        scene_res = {
            "scene": scene, "threshold": REF_THRESHOLDS.get(scene),
            "t_ref_s": round(t_ref, 1), "t_ours_s": round(t_ours, 1),
            "renders": [],
        }
        for rk, ok in zip(ref_keys, our_keys):
            a, b = ref_imgs[rk], our_imgs[ok]
            if a.shape != b.shape:
                scene_res["renders"].append(
                    {"ref": rk, "ours": ok, "error": f"shape {a.shape} vs {b.shape}"}
                )
                continue
            scene_res["renders"].append(
                {"ref": rk, "ours": ok, "psnr": round(psnr(a, b), 2)}
            )
        if args.self_psnr:
            d_ref2 = os.path.join(args.out, scene, "ref2")
            run_oracle(scene, d_ref2, rays=args.rays, seed=2)
            ref2 = read_images(d_ref2)
            selfs = [
                round(psnr(ref_imgs[k], ref2[k]), 2)
                for k in ref_keys if k in ref2
            ]
            scene_res["self_psnr"] = selfs
        results.append(scene_res)
        print(json.dumps(scene_res), flush=True)
    fails = [
        r["scene"] for r in results
        if r["threshold"] is not None and any(
            ("psnr" in x and x["psnr"] < r["threshold"]) or "error" in x
            for x in r["renders"]
        )
    ]
    print(json.dumps({"failing": fails, "n": len(results)}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

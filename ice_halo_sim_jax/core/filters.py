"""Ray-path filters with P/B/D crystal-symmetry folding, vectorized.

Mirrors the reference's filter system exactly:
  - canonicalization (ReduceBuffer): P prism-rotation shift, D sigma-mirror,
    B basal mirror, each keeping the lexicographically smaller form
    (/root/reference/src/core/shared/filter_shared.h:55-135, byte-identical
    semantics in vectorized form).
  - filter types none / raypath / entry_exit / direction / crystal / complex
    (OR-of-AND) with the action XOR (filter_spec.hpp:42-45).
  - D applicability: azimuth full-360 uniform AND roll mean at a multiple of
    30 deg; sigma_a = (6 - ((round(roll_mean/30) % 6 + 6) % 6)) % 6
    (crystal.hpp:357-366).

The device side operates on padded int32 face-number paths [N, L] with
per-row lengths; the host side canonicalizes each filter's configured
raypath once at plan-build time (FilterSpec::Create, filter_spec.cpp:335).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.schema import (
    AxisDistribution,
    ComplexFilter,
    CrystalFilter,
    DirectionFilter,
    DistType,
    EntryExitFilter,
    FilterAction,
    FilterConfig,
    NoneFilter,
    RaypathFilter,
    Symmetry,
)

FN_PERIOD = 6  # hexagonal family


# --------------------------------------------------------------------------
# D-symmetry applicability (crystal.hpp detail helpers)
# --------------------------------------------------------------------------

def is_roll_mean_multiple_of_30(roll_center_deg: float) -> bool:
    r = roll_center_deg / 30.0
    return abs(r - round(r)) < 1e-4


def compute_sigma_a(roll_mean_deg: float) -> int:
    n = (int(round(roll_mean_deg / 30.0)) % 6 + 6) % 6
    return (6 - n) % 6


def is_d_applicable(axis: AxisDistribution) -> bool:
    return axis.is_az_rotationally_symmetric() and is_roll_mean_multiple_of_30(axis.roll.center)


# --------------------------------------------------------------------------
# Host-side scalar canonicalization (for filter-config raypaths)
# --------------------------------------------------------------------------

def _p_shift_list(seq: List[int]) -> List[int]:
    out = list(seq)
    first_pri = None
    for i, x in enumerate(out):
        if x < 3:
            continue
        pyr, pri = divmod(x, 10)
        if first_pri is None:
            first_pri = pri
        pri = (pri + FN_PERIOD - first_pri) % FN_PERIOD + 3
        out[i] = pyr * 10 + pri
    return out


def _d_mirror_list(seq: List[int], sigma_a: int) -> List[int]:
    out = []
    for x in seq:
        if x < 3:
            out.append(x)
            continue
        pyr, pri = divmod(x, 10)
        new_pri0 = ((sigma_a - (pri - 3)) % FN_PERIOD + FN_PERIOD) % FN_PERIOD
        out.append(pyr * 10 + new_pri0 + 3)
    return out


def _b_mirror_list(seq: List[int]) -> Tuple[List[int], bool]:
    out = []
    changed = False
    for x in seq:
        if x <= 2:
            out.append(3 - x)
            changed = True
        elif 13 <= x <= 18:
            out.append(x + 10)
            changed = True
        elif 23 <= x <= 28:
            out.append(x - 10)
            changed = True
        else:
            out.append(x)
    return out, changed


def reduce_raypath(seq, symmetry: Symmetry, sigma_a: int = 0, d_applicable: bool = False) -> List[int]:
    """Scalar ReduceBuffer (filter_shared.h:81-135)."""
    data = list(int(x) for x in seq)
    if symmetry == Symmetry.NONE:
        return data
    if symmetry & Symmetry.P:
        data = _p_shift_list(data)
    if (symmetry & Symmetry.D) and d_applicable:
        scratch = _d_mirror_list(data, sigma_a)
        if symmetry & Symmetry.P:
            scratch = _p_shift_list(scratch)
        if scratch < data:
            data = scratch
    if symmetry & Symmetry.B:
        scratch, changed = _b_mirror_list(data)
        if changed and scratch < data:
            data = scratch
    return data


# --------------------------------------------------------------------------
# Vectorized canonicalization over padded [N, L] paths
# --------------------------------------------------------------------------

def _row_at(arr, idx):
    """arr[n, idx[n]] as a one-hot masked sum over the tiny path axis
    (L <= 64)."""
    L = arr.shape[-1]
    oh = jnp.arange(L, dtype=idx.dtype)[None, :] == idx[..., None]
    return jnp.sum(jnp.where(oh, arr, 0), axis=-1)


def _p_shift(paths, valid):
    is_pri = (paths >= 3) & valid
    has_pri = jnp.any(is_pri, axis=-1)
    first_idx = jnp.argmax(is_pri, axis=-1)
    first_val = _row_at(paths, first_idx)
    first_pri = jnp.where(has_pri, first_val % 10, 0)
    pyr = paths // 10
    pri = paths % 10
    new_pri = (pri + FN_PERIOD - first_pri[..., None]) % FN_PERIOD + 3
    return jnp.where(is_pri, pyr * 10 + new_pri, paths)


def _d_mirror(paths, valid, sigma_a):
    is_pri = (paths >= 3) & valid
    pyr = paths // 10
    pri0 = paths % 10 - 3
    new_pri0 = (sigma_a - pri0) % FN_PERIOD
    return jnp.where(is_pri, pyr * 10 + new_pri0 + 3, paths)


def _b_mirror(paths, valid):
    basal = (paths <= 2) & valid
    upper = (paths >= 13) & (paths <= 18) & valid
    lower = (paths >= 23) & (paths <= 28) & valid
    out = jnp.where(basal, 3 - paths, paths)
    out = jnp.where(upper, paths + 10, out)
    out = jnp.where(lower, paths - 10, out)
    changed = jnp.any(basal | upper | lower, axis=-1)
    return out, changed


def _lex_less(a, b, valid):
    """a < b lexicographically over the valid prefix. [N] bool."""
    diff = (a != b) & valid
    any_diff = jnp.any(diff, axis=-1)
    idx = jnp.argmax(diff, axis=-1)
    av = _row_at(a, idx)
    bv = _row_at(b, idx)
    return any_diff & (av < bv)


def reduce_paths(paths, lens, symmetry: Symmetry, sigma_a: int, d_applicable: bool):
    """Vectorized ReduceBuffer over [N, L] int32 face-number paths."""
    L = paths.shape[-1]
    valid = jnp.arange(L)[None, :] < lens[..., None]
    data = jnp.where(valid, paths, 0)
    if symmetry == Symmetry.NONE:
        return data
    if symmetry & Symmetry.P:
        data = _p_shift(data, valid)
    if (symmetry & Symmetry.D) and d_applicable:
        scratch = _d_mirror(data, valid, sigma_a)
        if symmetry & Symmetry.P:
            scratch = _p_shift(scratch, valid)
        take = _lex_less(scratch, data, valid)
        data = jnp.where(take[..., None], scratch, data)
    if symmetry & Symmetry.B:
        scratch, changed = _b_mirror(data, valid)
        take = changed & _lex_less(scratch, data, valid)
        data = jnp.where(take[..., None], scratch, data)
    return data


# --------------------------------------------------------------------------
# Filter plans (host-built static descriptors)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SimplePlan:
    kind: str                      # none|raypath|entry_exit|direction|crystal
    symmetry: Symmetry = Symmetry.NONE
    sigma_a: int = 0
    d_applicable: bool = False
    canonical: tuple = ()          # canonicalized face numbers
    min_len: int = 1
    max_len: Optional[int] = None
    has_entry: bool = False
    has_exit: bool = False
    dir_vec: tuple = (0.0, 0.0, 1.0)
    radii_c: float = -2.0
    crystal_match: bool = True     # resolved at build (setting crystal is static)


@dataclass(frozen=True)
class FilterPlan:
    action: FilterAction
    # OR-of-AND structure; simple filters are a single 1-clause entry.
    clauses: tuple = ()            # tuple of tuples of SimplePlan


def _build_simple(param, symmetry: Symmetry, sigma_a: int, d_applicable: bool,
                  setting_crystal_id: int) -> SimplePlan:
    if isinstance(param, NoneFilter):
        return SimplePlan(kind="none")
    if isinstance(param, RaypathFilter):
        canon = reduce_raypath(param.raypath, symmetry, sigma_a, d_applicable)
        return SimplePlan(kind="raypath", symmetry=symmetry, sigma_a=sigma_a,
                          d_applicable=d_applicable, canonical=tuple(canon))
    if isinstance(param, EntryExitFilter):
        ends = []
        if param.entry is not None:
            ends.append(param.entry)
        if param.exit is not None:
            ends.append(param.exit)
        canon = tuple(reduce_raypath(ends, symmetry, sigma_a, d_applicable)) if ends else ()
        return SimplePlan(kind="entry_exit", symmetry=symmetry, sigma_a=sigma_a,
                          d_applicable=d_applicable, canonical=canon,
                          min_len=param.min_len, max_len=param.max_len,
                          has_entry=param.entry is not None, has_exit=param.exit is not None)
    if isinstance(param, DirectionFilter):
        lat = math.radians(param.el)
        lon = math.radians(param.az)
        return SimplePlan(
            kind="direction",
            dir_vec=(math.cos(lat) * math.cos(lon), math.cos(lat) * math.sin(lon), math.sin(lat)),
            radii_c=math.cos(math.radians(param.radii)),
        )
    if isinstance(param, CrystalFilter):
        return SimplePlan(kind="crystal", crystal_match=(param.crystal_id == setting_crystal_id))
    raise ValueError(f"unexpected simple filter {param!r}")


def build_filter_plan(fcfg: FilterConfig, axis: AxisDistribution, all_filters: dict,
                      setting_crystal_id: int) -> FilterPlan:
    """FilterSpec::Create equivalent (filter_spec.cpp:373-380)."""
    d_app = is_d_applicable(axis)
    sigma_a = compute_sigma_a(axis.roll.center) if d_app else 0
    if isinstance(fcfg.param, ComplexFilter):
        clauses = []
        for clause in fcfg.param.composition:
            plans = []
            for ref in clause:
                sub = all_filters[ref]
                # Sub-filter symmetry comes from the SUB filter config; action
                # of sub-filters is ignored (only the complex's action applies).
                plans.append(
                    _build_simple(sub.param, sub.symmetry, sigma_a, d_app, setting_crystal_id)
                )
            clauses.append(tuple(plans))
        return FilterPlan(action=fcfg.action, clauses=tuple(clauses))
    simple = _build_simple(fcfg.param, fcfg.symmetry, sigma_a, d_app, setting_crystal_id)
    return FilterPlan(action=fcfg.action, clauses=((simple,),))


# --------------------------------------------------------------------------
# Vectorized match
# --------------------------------------------------------------------------

def _match_simple(plan: SimplePlan, paths, lens, dirs, reduced=None):
    n = paths.shape[0]
    if plan.kind == "none":
        return jnp.ones(n, bool)
    if plan.kind == "crystal":
        return jnp.full(n, plan.crystal_match)
    if plan.kind == "direction":
        d = jnp.asarray(plan.dir_vec, jnp.float32)
        return jnp.sum(dirs * d[None, :], axis=-1) > plan.radii_c
    if plan.kind == "raypath":
        clen = len(plan.canonical)
        L = paths.shape[-1]
        if clen > L:
            return jnp.zeros(n, bool)
        if reduced is None:
            reduced = reduce_paths(
                paths, lens, plan.symmetry, plan.sigma_a, plan.d_applicable
            )
        canon = jnp.zeros(L, jnp.int32).at[:clen].set(jnp.asarray(plan.canonical, jnp.int32))
        eq = jnp.all(jnp.where(jnp.arange(L)[None, :] < clen, reduced == canon[None, :], True), axis=-1)
        return (lens == clen) & eq
    if plan.kind == "entry_exit":
        ok = (lens > 0) & (lens >= plan.min_len)
        if plan.max_len is not None:
            ok &= lens <= plan.max_len
        if not (plan.has_entry or plan.has_exit):
            return ok
        first = paths[:, 0]
        last = _row_at(paths, jnp.maximum(lens - 1, 0))
        if plan.has_entry and plan.has_exit:
            ee = jnp.stack([first, last], axis=-1)
        elif plan.has_entry:
            ee = first[..., None]
        else:
            ee = last[..., None]
        ee_len = jnp.full(ee.shape[0], ee.shape[-1], jnp.int32)
        reduced = reduce_paths(ee, ee_len, plan.symmetry, plan.sigma_a, plan.d_applicable)
        canon = jnp.asarray(plan.canonical, jnp.int32)
        if canon.shape[0] != ee.shape[-1]:
            return jnp.zeros(ee.shape[0], bool)
        return ok & jnp.all(reduced == canon[None, :], axis=-1)
    raise ValueError(plan.kind)


def check_exits(plan: Optional[FilterPlan], paths, lens, dirs):
    """Filter verdict per exit (Check = Match XOR filter_out).

    paths: [N, L] int32 face numbers, lens: [N], dirs: [N, 3] world exit dirs.
    plan None -> all pass. Empty complex matches nothing
    (filter_shared.h:246-249 contract).
    """
    n = paths.shape[0]
    if plan is None:
        return jnp.ones(n, bool)
    matched = jnp.zeros(n, bool)
    # One canonicalization per distinct symmetry triple, shared by every
    # raypath predicate (the reference's design: ReduceBuffer_dev runs once
    # per ray, then compares against all packed targets —
    # filter_shared.h:37-140).
    cache = {}

    def reduced_for(s):
        k = (s.symmetry, s.sigma_a, s.d_applicable)
        if k not in cache:
            cache[k] = reduce_paths(paths, lens, *k)
        return cache[k]

    for clause in plan.clauses:
        and_ok = jnp.ones(n, bool)
        for simple in clause:
            r = reduced_for(simple) if simple.kind == "raypath" else None
            and_ok &= _match_simple(simple, paths, lens, dirs, reduced=r)
        matched |= and_ok
    if plan.action == FilterAction.FILTER_OUT:
        return ~matched
    return matched


# --------------------------------------------------------------------------
# Slot-major SoA match (the production trace path)
# --------------------------------------------------------------------------

def _col_at(arr, idx):
    """arr[idx[b], b] over [L, B] as a one-hot over the tiny path axis."""
    L = arr.shape[0]
    oh = jnp.arange(L, dtype=idx.dtype)[:, None] == idx[None, :]
    return jnp.sum(jnp.where(oh, arr, 0), axis=0)


def _p_shift_t(paths, valid):
    is_pri = (paths >= 3) & valid
    has_pri = jnp.any(is_pri, axis=0)
    first_idx = jnp.argmax(is_pri, axis=0)
    first_val = _col_at(paths, first_idx)
    first_pri = jnp.where(has_pri, first_val % 10, 0)
    pyr = paths // 10
    pri = paths % 10
    new_pri = (pri + FN_PERIOD - first_pri[None, :]) % FN_PERIOD + 3
    return jnp.where(is_pri, pyr * 10 + new_pri, paths)


def _d_mirror_t(paths, valid, sigma_a):
    is_pri = (paths >= 3) & valid
    pyr = paths // 10
    pri0 = paths % 10 - 3
    new_pri0 = (sigma_a - pri0) % FN_PERIOD
    return jnp.where(is_pri, pyr * 10 + new_pri0 + 3, paths)


def _b_mirror_t(paths, valid):
    basal = (paths <= 2) & valid
    upper = (paths >= 13) & (paths <= 18) & valid
    lower = (paths >= 23) & (paths <= 28) & valid
    out = jnp.where(basal, 3 - paths, paths)
    out = jnp.where(upper, paths + 10, out)
    out = jnp.where(lower, paths - 10, out)
    changed = jnp.any(basal | upper | lower, axis=0)
    return out, changed


def _lex_less_t(a, b, valid):
    diff = (a != b) & valid
    any_diff = jnp.any(diff, axis=0)
    idx = jnp.argmax(diff, axis=0)
    return any_diff & (_col_at(a, idx) < _col_at(b, idx))


def reduce_paths_t(paths, valid, symmetry: Symmetry, sigma_a: int,
                   d_applicable: bool):
    """reduce_paths over slot-major [Lh, B] paths (batch in the minor
    dimension, so every elementwise op runs over contiguous rays)."""
    data = jnp.where(valid, paths, 0)
    if symmetry == Symmetry.NONE:
        return data
    if symmetry & Symmetry.P:
        data = _p_shift_t(data, valid)
    if (symmetry & Symmetry.D) and d_applicable:
        scratch = _d_mirror_t(data, valid, sigma_a)
        if symmetry & Symmetry.P:
            scratch = _p_shift_t(scratch, valid)
        take = _lex_less_t(scratch, data, valid)
        data = jnp.where(take[None, :], scratch, data)
    if symmetry & Symmetry.B:
        scratch, changed = _b_mirror_t(data, valid)
        take = changed & _lex_less_t(scratch, data, valid)
        data = jnp.where(take[None, :], scratch, data)
    return data


def check_exits_prefix_soa(plan: Optional[FilterPlan], path, live, dirs):
    """Filter verdicts for every exit slot, slot-major (the trace kernel's
    native layout — no transposes, no H-fold path duplication).

    path: [H, B] int32 face numbers (slot h's raypath = path[:h+1, b]);
    live: [H, B] bool (slot emitted); dirs: (dx, dy, dz) each [H, B] world
    exit directions. Returns [H, B] bool verdicts (Match XOR filter_out).

    Static slot loop: a raypath predicate of canonical length C can only
    match at slot h == C-1, so every other slot skips it AT TRACE TIME —
    for OR-of-AND filters whose clauses pin specific lengths this removes
    almost all canonicalization work (the [N, L] formulation evaluated
    every clause against every slot).
    """
    H, B = path.shape
    if plan is None:
        return jnp.ones((H, B), bool)
    dx, dy, dz = dirs
    rows = []
    for h in range(H):
        p = path[: h + 1]
        lv = live[h]
        valid = jnp.broadcast_to(lv[None, :], (h + 1, B))
        cache = {}

        def reduced_for(s, p=p, valid=valid, cache=cache):
            k = (s.symmetry, s.sigma_a, s.d_applicable)
            if k not in cache:
                cache[k] = reduce_paths_t(p, valid, *k)
            return cache[k]

        matched = None
        for clause in plan.clauses:
            and_ok = None
            for s in clause:
                if s.kind == "none":
                    continue
                elif s.kind == "crystal":
                    if s.crystal_match:
                        continue
                    and_ok = jnp.zeros(B, bool)
                    break
                elif s.kind == "direction":
                    dvec = s.dir_vec
                    m = (
                        dx[h] * dvec[0] + dy[h] * dvec[1] + dz[h] * dvec[2]
                    ) > s.radii_c
                elif s.kind == "raypath":
                    if len(s.canonical) != h + 1:
                        and_ok = jnp.zeros(B, bool)
                        break
                    red = reduced_for(s)
                    canon = jnp.asarray(s.canonical, jnp.int32)
                    m = lv & jnp.all(red == canon[:, None], axis=0)
                elif s.kind == "entry_exit":
                    if (h + 1) < s.min_len or (
                        s.max_len is not None and (h + 1) > s.max_len
                    ):
                        and_ok = jnp.zeros(B, bool)
                        break
                    if not (s.has_entry or s.has_exit):
                        m = lv
                    else:
                        ends = []
                        if s.has_entry:
                            ends.append(p[0])
                        if s.has_exit:
                            ends.append(p[h])
                        ee = jnp.stack(ends, axis=0)        # [1|2, B]
                        canon = jnp.asarray(s.canonical, jnp.int32)
                        if canon.shape[0] != ee.shape[0]:
                            and_ok = jnp.zeros(B, bool)
                            break
                        red = reduce_paths_t(
                            ee, jnp.ones_like(ee, bool), s.symmetry,
                            s.sigma_a, s.d_applicable,
                        )
                        m = lv & jnp.all(red == canon[:, None], axis=0)
                else:
                    raise ValueError(s.kind)
                and_ok = m if and_ok is None else (and_ok & m)
            if and_ok is None:       # all-trivially-true clause
                and_ok = jnp.ones(B, bool)
            matched = and_ok if matched is None else (matched | and_ok)
        if matched is None:
            matched = jnp.zeros(B, bool)
        if plan.action == FilterAction.FILTER_OUT:
            matched = ~matched
        rows.append(matched)
    return jnp.stack(rows, axis=0)


def check_exits_slots(plan: Optional[FilterPlan], paths, path_lens, dirs):
    """Filter verdicts for H exit slots sharing one path buffer: [c, H].

    paths: [c, L] face numbers; path_lens: [c, H] per-slot prefix lengths;
    dirs: [c, H, 3] per-slot exit directions. Folds the slot axis into the
    batch so each symmetry canonicalization runs ONCE over [c*H, L] instead
    of once per slot per predicate.
    """
    c, L = paths.shape
    H = path_lens.shape[-1]
    if plan is None:
        return jnp.ones((c, H), bool)
    pb = jnp.broadcast_to(paths[:, None, :], (c, H, L)).reshape(c * H, L)
    out = check_exits(plan, pb, path_lens.reshape(-1), dirs.reshape(-1, 3))
    return out.reshape(c, H)

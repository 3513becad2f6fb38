"""The simulation engine: host driver + fused per-batch device step.

This replaces the reference's whole server/threading stack
(the reference's src/server/) with an accelerator formulation: there are no
queues or worker threads — one jit-compiled program samples, traces through
all scattering layers, projects, and accumulates an entire ray batch, and the
host loop just feeds batch counters. Accumulators are donated device arrays
(the "third clock" idea — XYZ stays device-resident across many steps and is
drained on demand, trace_backend.hpp:495-503).

Semantics mirrored from the reference:
  - ray_num is the total across wavelengths (server.cpp:1477-1495); each ray
    carries its own wavelength (the GPU wl-pool design, DR-3).
  - geometry clock: `geom_clock` rays share one sampled crystal shape
    (simulator.hpp:144-157); shapes live in a per-layer K-shape pool.
  - multi-scattering: per-exit probability gate — on non-final layers
    pass+roll<prob -> continuation, else accumulate; on the final layer
    roll<prob -> drop (cuda_trace_backend.cu:940-960, S1 Bug-3 semantics).
  - continuation rays are compacted into a fixed-size buffer and
    Feistel-shuffled to decorrelate the ray->crystal pairing
    (trace_backend.hpp:334-349).
  - two-rule stats: stochastic sample counts accumulate; deterministic
    crystal/orientation counts are config constants (trace_backend.hpp:525-625).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.schema import (
    CrystalConfig,
    DistType,
    NoneFilter,
    ProjectConfig,
    PrismShape,
    PyramidShape,
    sync_group_leaders,
)
from ice_halo_sim_jax.core import (
    color,
    filters,
    geometry,
    latlut,
    optics,
    projection,
    rng,
    sampling,
    trace,
    trace_soa,
)
from ice_halo_sim_jax.core import accum as accum_mod

DEFAULT_BATCH = 1 << 17
DEFAULT_GEOM_CLOCK = 32
# Component-mask bit budget (the reference's GPU component-mask cap; overflow
# degrades coloring rather than failing the commit — def.hpp:43-51).
COLOR_PREDICATE_CAP = 32


def largest_remainder_partition(total: int, proportions) -> list:
    """Exact integer split of `total` by proportions (PartitionCrystalRayNum,
    simulator.cpp:519-582, without the cross-batch carry — the split is
    identical every batch, so remainders never accumulate)."""
    props = np.maximum(np.asarray(proportions, np.float64), 0.0)
    s = props.sum()
    if s <= 0 or total == 0:
        return [0] * len(props)
    ideal = props / s * total
    alloc = np.floor(ideal).astype(np.int64)
    deficit = total - alloc.sum()
    order = np.argsort(-(ideal - alloc))
    for i in range(int(deficit)):
        alloc[order[i % len(props)]] += 1
    return [int(x) for x in alloc]


class LayerPlan(NamedTuple):
    """Static per-layer plan (host-side)."""

    prob: float
    n_settings: int
    setting_idx: np.ndarray      # [B_layer] lane -> setting
    shape_base: np.ndarray       # [B_layer] lane -> pool slot base (shape idx)
    setting_counts: list         # rays per setting
    k_per_setting: list          # shapes per setting in the pool
    axis_params: sampling.AxisParams
    shape_kinds: list            # "prism" | "pyramid" per setting
    shape_param_arrays: list     # per setting: dict of distribution params
    deterministic_shape: list    # per setting bool
    deterministic_axis: list     # per setting bool
    filter_plans: list           # per setting Optional[filters.FilterPlan]
    color_plans: list            # per setting list[(bit_idx, filters.FilterPlan)]
    crystal_ids: list            # per setting user crystal id
    cont_cap: int                # continuation buffer size feeding THIS layer


class Stats(NamedTuple):
    rays_traced: int = 0
    ray_segments: int = 0    # traced bounce segments (reference ray_seg_num)
    landed_weight: float = 0.0
    dropped_cont_weight: float = 0.0
    stochastic_crystal_samples: int = 0
    stochastic_orientation_samples: int = 0
    deterministic_crystal_count: int = 0
    deterministic_orientation_count: int = 0


def _dist_params(d) -> tuple:
    return (int(d.type), float(d.center), float(d.spread))


def _sample_shape_scalars(seed, k_idx, slot0, dist_tuple):
    dtype, center, spread = dist_tuple
    v = rng.sample_dist(seed, k_idx, slot0, dtype, center, spread)
    return v


class Engine:
    """Host-facing renderer: commit a config, pump batches, snapshot images.

    Single-chip by default; the sharded multi-chip path lives in
    ice_halo_sim_jax.parallel (same step function under shard_map).
    """

    def __init__(self, cfg: ProjectConfig, seed: int = 1, batch_size: int = DEFAULT_BATCH,
                 geom_clock: int = DEFAULT_GEOM_CLOCK, accum_method: str = "auto"):
        self.cfg = cfg
        self.seed = int(seed) & 0xFFFFFFFF
        self.batch_size = int(batch_size)
        self.geom_clock = int(geom_clock)
        self.accum_method = accum_method
        self._build_plan()
        self._build_wavelengths()
        self._build_renders()
        self.reset()
        self._step = jax.jit(
            self._step_impl,
            static_argnums=(3, 4),
            donate_argnums=(0,),
        )
        # Multi-batch dispatch: ONE device execution runs `n_steps` batches
        # via fori_loop, amortizing the fixed per-dispatch host cost — the
        # same discipline as the reference's dispatch grain
        # (LUMICE_DISPATCH_RAY_NUM). The default of 64 is inherited from
        # the earlier accelerator and not yet measured on the H100.
        self._multi_step = jax.jit(
            self._multi_step_impl,
            static_argnums=(2, 3, 4),
            donate_argnums=(0,),
        )
        from ice_halo_sim_jax.utils import env_knobs

        self.steps_per_dispatch = int(
            env_knobs.get("IHT_STEPS_PER_DISPATCH", 64)
        )
        # Runtime calibration from the first dispatch's measured counts:
        # dead-row compaction before the fold (None per render = off) and
        # continuation-capacity trimming (plan rebuild; _plan_version is the
        # static jit cache-buster).
        self._compact_keep = None
        self._plan_version = 0
        self._calibrated = False
        self._compact_enabled = str(env_knobs.get("IHT_COMPACT", "1")) not in (
            "0", "off", "false",
        )
        # Emit-time weight floor (fraction of the batch's mean initial ray
        # weight). Every live contribution row costs fold work; rows
        # carrying negligible radiance are thinned at emit time. Two modes
        # (IHT_EMIT_FLOOR):
        #   rr (default): Russian roulette — a row with w < cut survives
        #       with probability w/cut at weight cut. UNBIASED: the expected
        #       image equals the floorless one exactly (the reference has no
        #       emission floor, so default output matches reference
        #       semantics in expectation). Added
        #       variance is confined to rows below cut (<= 0.1% of mean ray
        #       weight at the default), far below Monte-Carlo noise.
        #   drop: biased hard drop (~1e-5 relative mass loss at 1e-3 on
        #       the bench scene), mass accounted into dropped weight.
        # Both modes cut ~20% of live fold rows on the bench scene.
        self.min_emit_frac = float(env_knobs.get("IHT_MIN_EMIT_W", 1e-3))
        self.emit_floor_mode = str(env_knobs.get("IHT_EMIT_FLOOR", "rr")).lower()
        # Per-ray exit-slot cap: the fold's cost is per contribution row and
        # deep exit slots are mostly dead (bench: slot-6 liveness 11%).
        # After per-ray slot compaction (trace_soa.compact_slots) the rows
        # are sliced to `_slot_cap`. None = calibrating: the first dispatch
        # measures the per-live-rank mass histogram and picks the smallest
        # cap whose dropped tail is < 1e-4 of emitted mass (usually zero
        # loss is impossible to distinguish from Monte-Carlo noise there);
        # the dropped mass is always accounted into dropped_cont_weight.
        # IHT_SLOT_CAP: "off" disables, an int pins it.
        cap_knob = env_knobs.get("IHT_SLOT_CAP")
        if cap_knob is None or str(cap_knob) == "auto":
            self._slot_cap = None
        elif str(cap_knob).lower() in ("off", "0"):
            self._slot_cap = self.max_hits
        else:
            self._slot_cap = max(1, min(self.max_hits, int(cap_knob)))
        self._recompute_rows_per_render()

    @property
    def fold_kind(self) -> str:
        """Which accumulation fold this engine runs ('scatter' | 'sort' |
        'sort-legacy'); benchmark output records it."""
        method = self.accum_method
        if method == "auto":
            method = accum_mod.AUTO_METHOD
        if method == "sort" and not self.spectral_ok:
            method = "sort-legacy"
        return method

    # Compaction keep margin over the measured per-batch live rows. Batch-
    # to-batch live-count CoV measures ~0.1% on the bench scenes (the live
    # count is a sum over ~1e6 near-independent Bernoulli rows), so 6% is
    # tens of sigmas; an overflowing batch still falls back to the exact
    # uncompacted fold via lax.cond (correctness never depends on this).
    _KEEP_MARGIN = 1.06

    def _recompute_rows_per_render(self) -> None:
        # Static contribution-row count per render per batch (slot-capped).
        cap = self._slot_cap if self._slot_cap is not None else self.max_hits
        cap = min(cap, self.max_hits)
        self._rows_per_render = [
            sum(
                len(plan.setting_idx) * cap
                for plan in self.layers
            ) * (2 if p.max_abs_dz > 0.0 else 1)
            for p in self.proj_plans
        ]

    # ------------------------------------------------------------------
    # Plan building (host)
    # ------------------------------------------------------------------

    def _build_color_bits(self):
        """Assign one component bit per raypath-color predicate and build its
        match plan (BuildColorSpecGroups semantics, filter_spec.cpp:384-425).

        Returns ({(layer, crystal_id): [(bit, plan)]}, [(class_mask, all?)])."""
        from ice_halo_sim_jax.config.schema import (
            FilterConfig as FC,
            NoneFilter as NF,
            RaypathFilter as RF,
            FilterAction as FA,
        )

        by_placement = {}
        class_defs = []
        bit = 0
        self.color_overflow_count = 0
        rc = self.cfg.raypath_color
        if rc is None:
            return by_placement, class_defs
        for cls in rc.classes:
            mask = 0
            for pred in cls.predicates:
                if bit >= COLOR_PREDICATE_CAP:
                    # Degrade instead of failing: excess predicates stop
                    # producing bits and the overflow is surfaced through
                    # Server.color_overflow_info (the reference's GPU-cap
                    # "coloring degraded" contract, LUMICE_GetColorOverflowInfo
                    # / def.hpp:43-51).
                    self.color_overflow_count += 1
                    continue
                crystal = self.cfg.crystals[pred.crystal_id]
                param = RF(raypath=pred.raypath) if pred.raypath else NF()
                plan = filters.build_filter_plan(
                    FC(id=0, param=param, symmetry=pred.symmetry, action=FA.FILTER_IN),
                    crystal.axis, self.cfg.filters, pred.crystal_id,
                )
                by_placement.setdefault((pred.layer, pred.crystal_id), []).append((bit, plan))
                mask |= 1 << bit
                bit += 1
            class_defs.append((mask, cls.combine_all))
        return by_placement, class_defs

    def _build_plan(self, cont_caps=None) -> None:
        """Build per-layer static plans. cont_caps: optional per-layer lane
        counts (index >= 1) overriding the continuation-capacity heuristic —
        the calibrated path (see _maybe_calibrate)."""
        cfg = self.cfg
        self.max_hits = int(cfg.scene.max_hits)
        color_by_placement, self.color_classes = self._build_color_bits()
        g = self.geom_clock
        # Lane counts are allocated in whole geom-clock blocks so the
        # ray -> pool-shape map is exactly `lane // geom_clock` — a blocked
        # assignment the trace expands with a broadcast instead of a
        # per-ray gather.
        self.batch_size = -(-self.batch_size // g) * g
        layers = []
        b_prev = self.batch_size
        det_crystals = 0
        det_orients = 0
        for li, ms in enumerate(cfg.scene.layers):
            settings = ms.entries
            if li == 0:
                b_layer = self.batch_size
            else:
                # Continuation capacity: expected continuations with slack,
                # clamped by the hard max (AllocateAllData, simulator.cpp:498-516).
                # A prism ray leaves ~0.67 * max_hits exit slots live
                # (measured 5.4/8 on the ms bench scenes), each continuing
                # with probability p; 1.3x margin covers batch fluctuation
                # and fatter geometries. Overflow drops lowest-weight rows
                # first (see the continuation sort below) and is accounted
                # in dropped_cont_weight.
                p_prev = cfg.scene.layers[li - 1].prob
                expect = b_prev * min(
                    1.3 * p_prev * 0.67 * self.max_hits, float(self.max_hits)
                )
                b_layer = int(min(max(expect, 1024), b_prev * self.max_hits))
                if cont_caps is not None and cont_caps[li] is not None:
                    b_layer = min(b_layer, max(int(cont_caps[li]), 1024))
                b_layer = -(-b_layer // (256 * g)) * (256 * g)
            blocks = largest_remainder_partition(
                b_layer // g, [e.proportion for e in settings]
            )
            counts = [b * g for b in blocks]
            setting_idx = np.repeat(np.arange(len(settings), dtype=np.int32), counts)
            shape_base = np.arange(b_layer, dtype=np.int32) // g
            axes = []
            shape_kinds = []
            shape_params = []
            det_shape = []
            det_axis = []
            filter_ids = []
            color_plans = []
            crystal_ids = []
            for e in settings:
                crystal: CrystalConfig = cfg.crystals[e.crystal_id]
                axes.append(crystal.axis)
                det_axis.append(crystal.axis.is_deterministic())
                if crystal.axis.is_deterministic():
                    det_orients += 1
                shape = crystal.shape
                det_shape.append(shape.is_deterministic())
                if shape.is_deterministic():
                    det_crystals += 1
                # Shape-scalar sync groups: a synced member consumes its
                # group leader's RNG slot, so the group shares one raw draw
                # per crystal instance (crystal_config.hpp:184-198; heights
                # fold with abs at use, face distances stay signed). The
                # loader leader-normalized the distributions already.
                leaders = sync_group_leaders(shape.sync_group)
                if isinstance(shape, PrismShape):
                    shape_kinds.append("prism")
                    slot_of = [0] + [2 + 2 * i for i in range(6)]
                    shape_params.append(
                        {
                            "h": _dist_params(shape.height),
                            "d": [_dist_params(x) for x in shape.face_distance],
                            "h_slot": slot_of[leaders[0]],
                            "d_slots": [slot_of[leaders[1 + i]] for i in range(6)],
                        }
                    )
                elif isinstance(shape, PyramidShape):
                    shape_kinds.append("pyramid")
                    slot_of = [0, 2, 4] + [6 + 2 * i for i in range(6)]
                    shape_params.append(
                        {
                            "u": _dist_params(shape.upper_h),
                            "p": _dist_params(shape.prism_h),
                            "l": _dist_params(shape.lower_h),
                            "au": float(shape.wedge_angle_u),
                            "al": float(shape.wedge_angle_l),
                            "d": [_dist_params(x) for x in shape.face_distance],
                            "u_slot": slot_of[leaders[0]],
                            "p_slot": slot_of[leaders[1]],
                            "l_slot": slot_of[leaders[2]],
                            "d_slots": [slot_of[leaders[3 + i]] for i in range(6)],
                        }
                    )
                else:
                    raise ValueError(f"unsupported shape {type(shape)}")
                crystal_ids.append(e.crystal_id)
                if e.filter_id != 0:
                    filter_ids.append(
                        filters.build_filter_plan(
                            cfg.filters[e.filter_id], crystal.axis, cfg.filters, e.crystal_id
                        )
                    )
                else:
                    filter_ids.append(None)
                color_plans.append(color_by_placement.get((li, e.crystal_id), []))
            luts = [latlut.build_lat_lut(a.latitude) for a in axes]
            # Deterministic shapes collapse to ONE pool row per setting: every
            # geom-clock block would sample the identical crystal, so a single
            # shared row (broadcast at expand time) is exact — and when the
            # whole layer is one deterministic setting, the trace kernel takes
            # the shared-table matmul path.
            k_per = [
                0 if c == 0 else (1 if det else max(1, b))
                for c, b, det in zip(counts, blocks, det_shape)
            ]
            layers.append(
                LayerPlan(
                    prob=float(ms.prob),
                    n_settings=len(settings),
                    setting_idx=setting_idx,
                    shape_base=shape_base,
                    setting_counts=counts,
                    k_per_setting=k_per,
                    axis_params=sampling.make_axis_params(axes, luts),
                    shape_kinds=shape_kinds,
                    shape_param_arrays=shape_params,
                    deterministic_shape=det_shape,
                    deterministic_axis=det_axis,
                    filter_plans=filter_ids,
                    color_plans=color_plans,
                    crystal_ids=crystal_ids,
                    cont_cap=b_layer,
                )
            )
            b_prev = b_layer
        self.layers = layers
        self.det_crystal_count = det_crystals
        self.det_orientation_count = det_orients
        # Unified face-slot count: pools concatenate across settings, so a
        # mixed prism/pyramid layer pads prisms out to the 20-slot layout.
        self.any_pyramid = any(k == "pyramid" for l in layers for k in l.shape_kinds)

    def _build_wavelengths(self) -> None:
        light = self.cfg.light
        if light.illuminant is not None:
            self.wl_mode = "illuminant"
            self.wl_table = None
            self.wl_weights = None
            self.illuminant = light.illuminant
        else:
            self.wl_mode = "discrete"
            self.wl_table = jnp.asarray([w.wl for w in light.spectrum], jnp.float32)
            self.wl_weights = jnp.asarray([w.weight for w in light.spectrum], jnp.float32)
        # Wavelength POOL size (the reference's per-ray wl pool,
        # trace_backend.hpp:521): each batch uses k_pool distinct wavelengths
        # so the accumulation sort can pack the pool index into its key and
        # rebuild the CMF basis post-sort (accum.fold_spectral). Discrete
        # spectra use their exact table; continuous illuminants draw a fresh
        # pool per batch (unbiased across batches).
        from ice_halo_sim_jax.utils import env_knobs

        if self.wl_mode == "discrete":
            n_wl = int(self.wl_table.shape[0])
            k_pool = 1 << (n_wl - 1).bit_length() if n_wl > 1 else 1
        else:
            k_pool = int(env_knobs.get("IHT_WL_POOL", 64))
            k_pool = 1 << max(0, (k_pool.bit_length() - 1))  # floor to pow2
        p_max = max(
            (r.resolution[0] * r.resolution[1] for r in self.cfg.renders),
            default=1,
        )
        while k_pool > 1 and not accum_mod.spectral_key_bits(p_max, k_pool):
            k_pool //= 2
        self.k_pool = k_pool
        # Spectral fold needs the key to fit AND (discrete case) the whole
        # table to fit the pool; otherwise fall back to dense-value folding.
        self.spectral_ok = accum_mod.spectral_key_bits(p_max, k_pool) and (
            self.wl_mode == "illuminant"
            or int(self.wl_table.shape[0]) <= k_pool
        )

    def _build_renders(self) -> None:
        self.proj_plans = [projection.make_proj_plan(r) for r in self.cfg.renders]

    def reset(self) -> None:
        # One combined accumulator per render: [H*W, 3 + n_classes] — XYZ
        # channels plus one Y lane per color class. A single buffer lets the
        # whole image pass run as ONE binning op per render.
        n_classes = len(self.color_classes)
        accum = [
            jnp.zeros((p.height * p.width, 3 + n_classes), jnp.float32)
            for p in self.proj_plans
        ]
        self.accum = tuple(accum) + (jnp.zeros((len(self.proj_plans),), jnp.float32),)
        self.stats = Stats(
            deterministic_crystal_count=self.det_crystal_count,
            deterministic_orientation_count=self.det_orientation_count,
        )
        self.batch_counter = 0
        self._pending_dropped = []
        self._pending_segments = []

    # ------------------------------------------------------------------
    # Device step
    # ------------------------------------------------------------------

    def _sample_layer_pool(self, li: int, plan: LayerPlan, batch_counter):
        """Sample the layer's K-shape geometry pool (inside jit)."""
        seed0 = jnp.uint32(self.seed) ^ rng.NONCE_GEOM_SHAPE ^ jnp.uint32(li * 0x9E37)
        geoms = []
        k_total = sum(plan.k_per_setting)
        # 64-bit shape index: batch_counter * k_total wraps u32 after
        # ~2^32/k_total batches (reachable in minutes at bench k_total);
        # mix the hi word into the seed exactly like the ray-base epoch.
        kb_lo, kb_hi = rng.mul_u32_split(batch_counter, k_total)
        k_off = 0
        layer_nf = geometry.PYRAMID_FACES if any(
            k == "pyramid" for k in plan.shape_kinds
        ) else geometry.PRISM_FACES
        for s, kind in enumerate(plan.shape_kinds):
            k = plan.k_per_setting[s]
            k_idx = kb_lo + jnp.uint32(k_off) + jnp.arange(k, dtype=jnp.uint32)
            seed = rng.epoch_seed(seed0, kb_lo, kb_hi, k_idx)
            sp = plan.shape_param_arrays[s]
            if kind == "prism":
                h = jnp.abs(_sample_shape_scalars(seed, k_idx, sp["h_slot"], sp["h"]))
                dists = jnp.stack(
                    [_sample_shape_scalars(seed, k_idx, sp["d_slots"][i], sp["d"][i]) for i in range(6)],
                    axis=-1,
                )
                g = geometry.prism_geom_batch(h, dists)
            else:
                from ice_halo_sim_jax.core import pyramid as pyramid_mod

                h1 = jnp.abs(_sample_shape_scalars(seed, k_idx, sp["u_slot"], sp["u"]))
                h2 = jnp.abs(_sample_shape_scalars(seed, k_idx, sp["p_slot"], sp["p"]))
                h3 = jnp.abs(_sample_shape_scalars(seed, k_idx, sp["l_slot"], sp["l"]))
                dists = jnp.stack(
                    [_sample_shape_scalars(seed, k_idx, sp["d_slots"][i], sp["d"][i]) for i in range(6)],
                    axis=-1,
                )
                g = pyramid_mod.pyramid_geom_batch(h1, h2, h3, sp["au"], sp["al"], dists)
            geoms.append(geometry.pad_geom_faces(g, layer_nf))
            k_off += k
        g = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *geoms) if len(geoms) > 1 else geoms[0]
        tris = jax.vmap(sampling.build_entry_tris)(g)
        return trace.make_geom_pool(g, tris)

    def _wl_from_idx(self, wl_idx, batch_counter):
        """Wavelength of pool entry `wl_idx` (pure function — the fold
        recomputes it post-sort from key bits alone).

        Illuminants: the pool is a FIXED midpoint-stratified grid over
        [380, 780] nm. Physics (IOR, SPD weight) uses a continuous per-ray
        wavelength (see _wavelength_draw); the pool quantizes only the CIE
        basis of the accumulation fold (< 400/K nm bins — midpoint-rule
        error O(h^2) in the CMF, ~1e-4 relative at K = 64). The round-3
        per-batch random pools starved lambda-dispersed features of
        spectral diversity: K x n_batches distinct wavelengths total made
        the cza arc measurably off (1.8 dB below the reference's own
        run-to-run floor) because every ray in a batch shared 64 arc
        radii."""
        if self.wl_mode == "discrete":
            return self.wl_table[wl_idx.astype(jnp.int32)]
        k = jnp.float32(400.0 / self.k_pool)
        return 380.0 + (wl_idx.astype(jnp.float32) + 0.5) * k

    def _xyz_basis(self, wl_idx, batch_counter):
        """CIE XYZ response per unit weight for pool entry `wl_idx` [M].

        Evaluates the CMF once on the K pool wavelengths and gathers by
        index: the piecewise-Chebyshev evaluation runs on K values, not on
        every fold row."""
        pool_idx = jnp.arange(self.k_pool, dtype=jnp.uint32)
        basis_tbl = color.cmf_eval(self._wl_from_idx(pool_idx, batch_counter))
        return basis_tbl[wl_idx.astype(jnp.int32)]

    def _wavelength_draw(self, lane_idx, batch_counter, seed_vec=None):
        """Per-ray (wavelength, init weight, pool index) — the GPU per-ray
        wl-pool formulation (trace_backend.hpp:521). seed_vec: per-ray
        epoch-mixed seed (64-bit ray-index contract); scalar seed when
        absent."""
        if self.wl_mode == "discrete":
            n_wl = self.wl_table.shape[0]
            wl_idx = (lane_idx % jnp.uint32(n_wl)).astype(jnp.uint32)
            wl = self._wl_from_idx(wl_idx, batch_counter)
            w0 = self.wl_weights[wl_idx.astype(jnp.int32)]
        else:
            base = jnp.uint32(self.seed) if seed_vec is None else seed_vec
            seed = base ^ rng.NONCE_WL ^ jnp.uint32(0x6A09E667)
            u = rng.uniform(seed, lane_idx, 0)
            # CONTINUOUS per-ray wavelength for the physics (IOR — arc
            # positions are exact per ray, matching the reference's
            # uniform-[380,780] draw, simulator.cpp:1087); the pool stratum
            # quantizes only the fold's CIE basis (_wl_from_idx).
            wl = 380.0 + u * 400.0
            wl_idx = jnp.minimum(
                (u * self.k_pool).astype(jnp.uint32), jnp.uint32(self.k_pool - 1)
            )
            # The SPD weight is evaluated on the K stratum midpoints and
            # gathered by index (midpoint rule per stratum — unbiased to
            # O(h^2)).
            pool_idx = jnp.arange(self.k_pool, dtype=jnp.uint32)
            spd_tbl = color.illuminant_spd_fast(
                self.illuminant, self._wl_from_idx(pool_idx, batch_counter)
            )                                                    # [K]
            w0 = spd_tbl[wl_idx.astype(jnp.int32)]
        return wl, w0, wl_idx

    def _trace_batch_impl(self, batch_base, batch_counter, n_active=None,
                          base_hi=None):
        """One full batch: sample -> trace all layers -> project.

        Returns (contribs, landed_add, dropped_w, seg_count) where contribs
        is a list per render of (pix [N_r] i32, w [N_r] f32, wl_idx [N_r]
        u32, mask [N_r] u32) SPECTRAL contribution rows — the XYZ/lane
        channels are expanded at fold time (accum.fold_spectral recomputes
        the CMF basis after its sort so only one f32 column rides it).

        n_active: optional traced u32 — lanes >= n_active start with zero
        weight (the exact-ray-budget tail batch; the reference traces
        exactly the requested ray_num, server.cpp:1477-1495). Dead lanes
        emit nothing, continue nothing, and count zero segments.

        The whole hot path is SoA (core/trace_soa.py): directions are
        component triples, per-slot arrays are [H, B] slot-major, so every
        elementwise op runs with the batch in the contiguous minor dimension.
        """
        B = self.batch_size
        lane = jnp.arange(B, dtype=jnp.uint32)
        ray_idx = batch_base + lane
        seed0 = jnp.uint32(self.seed)
        if base_hi is None:
            base_hi = jnp.uint32(0)
        # Per-ray epoch-mixed seed: every ray-index stream consumer below
        # keys on the FULL 64-bit global ray index (base_hi + carry past a
        # u32 wrap), not its low word — otherwise all orientation / sun /
        # gate / wavelength streams repeat verbatim every 2^32 rays (the
        # reference's documented silent-undersampling bug, SplitPcgRayBase,
        # trace_backend.hpp:160-190). Identity (bit-exact streams) while
        # the session is under 2^32 rays.
        seed_vec = rng.epoch_seed(seed0, batch_base, base_hi, ray_idx)

        wl, w0, wl_idx = self._wavelength_draw(ray_idx, batch_counter, seed_vec)
        # Emit-threshold scale: mean initial weight of this batch (pure
        # function of the spectrum draw — identical across renders/layers).
        w_scale = jnp.mean(w0)
        if n_active is not None:
            w0 = jnp.where(lane < n_active, w0, 0.0)
        n_ior = optics.ice_refractive_index(wl)

        d_world = sampling.sample_sun_dirs_soa(
            seed_vec ^ rng.NONCE_SUN, ray_idx,
            self.cfg.light.sun.azimuth, self.cfg.light.sun.altitude,
            self.cfg.light.sun.diameter,
        )

        n_renders = len(self.proj_plans)
        n_classes = len(self.color_classes)
        contrib_rows = [[] for _ in range(n_renders)]  # (pix, w, idx, mask)
        landed_add = [jnp.float32(0.0)] * n_renders
        dropped_w = jnp.float32(0.0)

        carried_mask = jnp.zeros((B,), jnp.uint32)
        seg_count = jnp.uint32(0)
        slot_mass = jnp.zeros((self.max_hits,), jnp.float32)
        cont_demand = []   # pre-truncation continuation counts per boundary
        n_layers = len(self.layers)
        for li, plan in enumerate(self.layers):
            layer_nonce = jnp.uint32(0xA5A5 * (li + 1))
            layer_seed = seed0 ^ layer_nonce      # scalar (shuffle hash)
            pool = self._sample_layer_pool(li, plan, batch_counter)

            if li > 0:
                # d_world/weights/wl arrive from the continuation buffer
                # (below); the wavelength itself is recomputed from the
                # carried pool index.
                d_world, w0, wl_idx, ray_idx, carried_mask = cont
                seed_vec = rng.epoch_seed(seed0, batch_base, base_hi, ray_idx)
                wl = self._wl_from_idx(wl_idx, batch_counter)
                n_ior = optics.ice_refractive_index(wl)
            layer_seed_vec = seed_vec ^ layer_nonce

            # Orientation: one contiguous segment per setting (static slices;
            # no per-ray parameter gathers). sample_rot_row produces the 9
            # rotation components directly — closed-form full-sphere path
            # (no arcsin).
            rot_parts = []
            off = 0
            for s, c in enumerate(plan.setting_counts):
                if c == 0:
                    continue
                rot_parts.append(
                    sampling.sample_rot_row(
                        layer_seed_vec[off : off + c] ^ rng.NONCE_ORIENT,
                        ray_idx[off : off + c],
                        plan.axis_params, s,
                    )
                )
                off += c
            rot = tuple(
                jnp.concatenate([p[i] for p in rot_parts])
                if len(rot_parts) > 1 else rot_parts[0][i]
                for i in range(9)
            )

            exits = trace_soa.trace_layer_soa(
                layer_seed_vec, ray_idx, d_world, w0, rot, pool, n_ior,
                self.max_hits,
                setting_blocks=tuple(zip(plan.k_per_setting, plan.setting_counts)),
            )

            H = self.max_hits
            exit_w = exits.w                                  # [H, B_l]
            # Traced segments = bounces until lane death = deepest live
            # exit slot per ray (reference ray_seg_num accounting).
            slot_len = jnp.arange(1, H + 1, dtype=jnp.int32)[:, None]
            seg_count = seg_count + jnp.sum(
                jnp.max(
                    jnp.where(exit_w > 0.0, slot_len, 0), axis=0
                ).astype(jnp.uint32)
            )

            # Filter emit gate (Design A: the filter runs simulator-side and a
            # failing exit neither accumulates nor continues,
            # doc/filter-architecture.md / CollectData 1.3). Filters consume
            # the trace's native slot-major [H, B] layout — no transposes,
            # and raypath predicates statically skip slots whose prefix
            # length cannot match (check_exits_prefix_soa).
            if any(fp is not None for fp in plan.filter_plans):
                live_slots = exit_w > 0.0                     # [H, B_l]
                seg_masks = []
                off = 0
                for s, c in enumerate(plan.setting_counts):
                    if c == 0:
                        continue
                    fp = plan.filter_plans[s]
                    if fp is None:
                        seg_masks.append(jnp.ones((H, c), bool))
                    else:
                        seg_masks.append(
                            filters.check_exits_prefix_soa(
                                fp, exits.path[:, off : off + c],
                                live_slots[:, off : off + c],
                                (exits.dx[:, off : off + c],
                                 exits.dy[:, off : off + c],
                                 exits.dz[:, off : off + c]),
                            )
                        )
                    off += c
                fmask = (
                    jnp.concatenate(seg_masks, axis=1)
                    if len(seg_masks) > 1 else seg_masks[0]
                )
                exit_w = jnp.where(fmask, exit_w, 0.0)

            # Probability gate per exit slot (stream: ray idx, slot 100 + h).
            gate_seed = layer_seed_vec[None, :] ^ rng.NONCE_GATE
            slot_ids = jnp.arange(H, dtype=jnp.uint32)[:, None]
            u = rng.uniform(gate_seed, ray_idx[None, :], jnp.uint32(100) + slot_ids)  # [H, B_l]
            is_last = li == n_layers - 1
            if plan.prob > 0.0 and not is_last:
                to_continue = (u < plan.prob) & (exit_w > 0.0)
                acc_mask = ~to_continue
            elif plan.prob > 0.0 and is_last:
                to_continue = jnp.zeros_like(exit_w, bool)
                acc_mask = u >= plan.prob  # would-continue rays are dropped
            else:
                to_continue = jnp.zeros_like(exit_w, bool)
                acc_mask = jnp.ones_like(exit_w, bool)

            # Component mask per exit: carried bits OR bits produced by this
            # layer's color predicates (evaluated per setting segment on the
            # exit's path — CollectData Design-2 color pass semantics).
            exit_mask = jnp.broadcast_to(carried_mask[None, :], exit_w.shape)
            if n_classes and any(plan.color_plans):
                live_slots = exit_w > 0.0                     # [H, B_l]
                seg_bits = []
                off = 0
                for s, c in enumerate(plan.setting_counts):
                    if c == 0:
                        continue
                    bits = jnp.zeros((H, c), jnp.uint32)
                    for bit_idx, cplan in plan.color_plans[s]:
                        match = filters.check_exits_prefix_soa(
                            cplan, exits.path[:, off : off + c],
                            live_slots[:, off : off + c],
                            (exits.dx[:, off : off + c],
                             exits.dy[:, off : off + c],
                             exits.dz[:, off : off + c]),
                        )
                        bits = bits | jnp.where(match, jnp.uint32(1 << bit_idx), 0)
                    seg_bits.append(bits)
                    off += c
                produced = (
                    jnp.concatenate(seg_bits, axis=1)
                    if len(seg_bits) > 1 else seg_bits[0]
                )
                exit_mask = exit_mask | produced

            acc_w = jnp.where(acc_mask, exit_w, 0.0)          # [H, B_l]
            if self.min_emit_frac > 0.0:
                # Emit-time weight floor (see __init__): sub-threshold exits
                # are thinned from accumulation only (NOT from continuation —
                # the physics of carried weight is untouched). The net mass
                # delta is accounted into dropped weight so energy
                # bookkeeping stays an exact identity per batch (in rr mode
                # the delta is a zero-mean residual). landed weight is
                # computed from the post-floor rows, so image mass and
                # landed mass remain consistent.
                w_cut = jnp.float32(self.min_emit_frac) * w_scale
                tiny = (acc_w > 0.0) & (acc_w < w_cut)
                if self.emit_floor_mode == "rr":
                    u_rr = rng.uniform(
                        layer_seed_vec[None, :] ^ rng.NONCE_EMIT,
                        ray_idx[None, :], slot_ids,
                    )
                    survive = u_rr * w_cut < acc_w
                    new_w = jnp.where(
                        tiny, jnp.where(survive, w_cut, 0.0), acc_w
                    )
                else:
                    new_w = jnp.where(tiny, 0.0, acc_w)
                dropped_w = dropped_w + jnp.sum(acc_w) - jnp.sum(new_w)
                acc_w = new_w
            cap = self._slot_cap if self._slot_cap is not None else H
            if self._slot_cap is None:
                # Calibration dispatch: per-live-rank mass histogram (no
                # compaction yet) — rank c's mass is what a cap of c would
                # drop from this slot downward.
                lv = (acc_w > 0.0).astype(jnp.int32)
                rank = jnp.cumsum(lv, axis=0) - lv
                slot_mass = slot_mass + jnp.stack([
                    jnp.sum(jnp.where((lv > 0) & (rank == c), acc_w, 0.0))
                    for c in range(H)
                ])
            if cap < H:
                # Per-ray live-first slot compaction (trace_soa.compact_slots)
                # — drops 30-70% of fold rows; rays with more than `cap`
                # live exits lose their deepest ones, accounted below.
                mask_cols = [exit_mask] if n_classes else []
                comp, keep_m, _nl = trace_soa.compact_slots(
                    acc_w > 0.0,
                    [acc_w, exits.dx, exits.dy, exits.dz] + mask_cols,
                    cap,
                )
                cw = jnp.where(keep_m, comp[0], 0.0)
                dropped_w = dropped_w + jnp.sum(acc_w) - jnp.sum(cw)
                flat_w = cw.reshape(-1)
                flat_dx = comp[1].reshape(-1)
                flat_dy = comp[2].reshape(-1)
                flat_dz = comp[3].reshape(-1)
                flat_mask = (
                    jnp.where(keep_m, comp[4], 0).reshape(-1)
                    if n_classes else jnp.zeros_like(flat_w, jnp.uint32).reshape(-1)
                )
                flat_idx = jnp.broadcast_to(
                    wl_idx[None, :], (cap, exit_w.shape[1])
                ).reshape(-1)
            else:
                flat_w = acc_w.reshape(-1)
                flat_dx = exits.dx.reshape(-1)
                flat_dy = exits.dy.reshape(-1)
                flat_dz = exits.dz.reshape(-1)
                flat_mask = exit_mask.reshape(-1)
                flat_idx = jnp.broadcast_to(wl_idx[None, :], exit_w.shape).reshape(-1)

            # The XYZ + per-class Y-lane channels are NOT expanded here: a
            # contribution row is (pixel, weight, wl-pool idx, mask) and the
            # fold rebuilds the channels post-sort (same pixels/exposure as
            # the mono image — the shared-exposure hard invariant,
            # render.cpp:398 — holds because lanes reuse the same rows).
            for r, pplan in enumerate(self.proj_plans):
                hits = projection.project_components(
                    pplan, flat_dx, flat_dy, flat_dz
                )
                main_ok = (hits.main >= 0) & (flat_w > 0.0)
                pix = jnp.where(main_ok, hits.main, -1)
                w_row = jnp.where(main_ok, flat_w, 0.0)
                contrib_rows[r].append((pix, w_row, flat_idx, flat_mask))
                landed_add[r] = landed_add[r] + jnp.sum(w_row)
                # Overlap writes do NOT enter landed weight
                # (render.cpp:376-390); the pass exists only for dual-fisheye
                # renders with a nonzero overlap band (static skip otherwise).
                if pplan.max_abs_dz > 0.0:
                    ov_ok = (hits.overlap >= 0) & (flat_w > 0.0)
                    ov_pix = jnp.where(ov_ok, hits.overlap, -1)
                    contrib_rows[r].append(
                        (ov_pix, jnp.where(ov_ok, flat_w, 0.0), flat_idx, flat_mask)
                    )

            if not is_last:
                next_plan = self.layers[li + 1]
                cap = next_plan.cont_cap
                cont_w_all = jnp.where(to_continue, exit_w, 0.0).reshape(-1)
                cont_live = cont_w_all > 0.0
                n_live = jnp.sum(cont_live.astype(jnp.uint32))
                cont_demand.append(n_live)
                # Compaction + shuffle, scatter-free. Key layout (u32): live
                # rows get (inverted weight bucket) << 23 | hash(row) — hash
                # order decorrelates the ray->crystal pairing the reference's
                # Feistel shuffle exists for (trace_backend.hpp:334-349);
                # dead rows key to 0xFFFFFFFF.
                #
                # Fast path (no overflow): block-local sort by that key +
                # block writes (accum.compact_by_key) — the continuation
                # carries 6-7 payload columns, so one global sort of all of
                # them is the costly formulation. Block-
                # local ordering shuffles within 4096-row blocks (pools are
                # resampled every batch, so block-local decorrelation
                # suffices). Slow path (lax.cond, rare): continuations
                # overflow `cap` — the exact global sort keeps the
                # energy-least-first truncation guarantee (lowest-weight
                # rows dropped, accounted in dropped_cont_weight).
                n_rows = cont_w_all.shape[0]
                wq = jnp.clip(
                    jnp.floor(
                        jnp.log2(jnp.maximum(cont_w_all, 1e-30))
                    ).astype(jnp.int32) + 130,
                    2, 255,
                )
                row_hash = rng.pcg_hash(
                    jnp.arange(n_rows, dtype=jnp.uint32)
                    ^ (layer_seed ^ rng.NONCE_SHUFFLE)
                    ^ rng.pcg_hash(batch_counter)  # fresh shuffle per batch
                )
                key = jnp.where(
                    cont_live,
                    ((jnp.uint32(255) - wq.astype(jnp.uint32)) << 23)
                    | (row_hash & jnp.uint32(0x7FFFFF)),
                    jnp.uint32(0xFFFFFFFF),
                )
                mask_cols = (
                    [exit_mask.reshape(-1)] if n_classes else []
                )
                # Continuation columns come from the UNCAPPED [H, B] exits:
                # cont_w_all/key are built from exit_w, and the slot cap
                # only trims ACCUMULATION rows — reusing the capped flat_*
                # here mixed [cap*B] columns into an [H*B] compaction
                # (shape crash on any cap < H multi-layer scene; r4
                # regression, tests/test_sentinels.py slot-cap sentinel).
                cols = [
                    cont_w_all,
                    jnp.broadcast_to(wl_idx[None, :], exit_w.shape).reshape(-1),
                ] + mask_cols + [
                    exits.dx.reshape(-1), exits.dy.reshape(-1),
                    exits.dz.reshape(-1),
                ]
                eff_cap = min(cap, n_rows)

                def fast(_):
                    outs, _n = accum_mod.compact_by_key(key, cols, eff_cap)
                    return outs[1:]

                def slow(_):
                    sorted_ops = jax.lax.sort(
                        tuple([key] + cols), num_keys=1, is_stable=False
                    )
                    return tuple(x[:eff_cap] for x in sorted_ops[1:])

                picked = jax.lax.cond(n_live <= jnp.uint32(eff_cap), fast, slow, 0)
                if n_classes:
                    (s_w, s_idx, s_mask, s_dx, s_dy, s_dz) = picked
                else:
                    (s_w, s_idx, s_dx, s_dy, s_dz) = picked
                    s_mask = jnp.zeros_like(s_idx, jnp.uint32)
                if eff_cap < cap:
                    pad = cap - eff_cap
                    s_w = jnp.pad(s_w, (0, pad))
                    s_dx = jnp.pad(s_dx, (0, pad))
                    s_dy = jnp.pad(s_dy, (0, pad))
                    s_dz = jnp.pad(s_dz, (0, pad))
                    s_idx = jnp.pad(s_idx, (0, pad))
                    s_mask = jnp.pad(s_mask, (0, pad))
                live = s_w > 0.0
                cont_wv = jnp.where(live, s_w, 0.0)
                # Empty lanes keep pool entry 0 — any real pool wavelength is
                # benign (finite IOR); weights are zero anyway.
                cont_idx = jnp.where(live, s_idx, 0).astype(jnp.uint32)
                cont_mask = jnp.where(live, s_mask.astype(jnp.uint32), 0)
                c_dx = jnp.where(live, s_dx, 0.0)
                c_dy = jnp.where(live, s_dy, 0.0)
                c_dz = jnp.where(live, s_dz, 0.0)
                dropped_w = dropped_w + jnp.sum(cont_w_all) - jnp.sum(cont_wv)
                next_ray_idx = batch_base + jnp.uint32(B * (li + 1)) + jnp.arange(cap, dtype=jnp.uint32)
                cont = ((c_dx, c_dy, c_dz), cont_wv, cont_idx, next_ray_idx, cont_mask)

        contribs = []
        for r in range(n_renders):
            parts = contrib_rows[r]
            if len(parts) > 1:
                contribs.append(tuple(
                    jnp.concatenate([p[c] for p in parts]) for c in range(4)
                ))
            else:
                contribs.append(parts[0])
        cont_demand = (
            jnp.stack(cont_demand) if cont_demand
            else jnp.zeros((0,), jnp.uint32)
        )
        return (contribs, jnp.stack(landed_add), dropped_w, seg_count,
                cont_demand, slot_mass)

    def _expand_vals(self, w, wl_idx, mask, batch_counter):
        """Dense [N, 3+L] channel rows from spectral rows (the non-spectral
        fold paths: scatter on CPU, legacy sort when the key won't pack)."""
        basis = self._xyz_basis(wl_idx, batch_counter)        # [N, 3]
        chans = [basis * w[:, None]]
        y = basis[:, 1] * w
        for bits, combine_all in self.color_classes:
            b = jnp.uint32(bits)
            member = (mask & b) == b if combine_all else (mask & b) != 0
            chans.append(jnp.where(member, y, 0.0)[:, None])
        return jnp.concatenate(chans, axis=-1) if len(chans) > 1 else chans[0]

    def _step_impl(self, accum, batch_base, batch_counter, keep=None,
                   plan_version: int = 0, n_active=None, base_hi=None):
        """One batch, folded into the accumulators immediately.

        accum: tuple of per-render [H*W, C] XYZ(+lanes) + [R] landed
        weights (donated). keep: optional static tuple per render — run the
        fold's scan/extraction stages on only that many sorted rows (the
        fold's ONE sort pushes all dead rows past every marker, so a
        prefix of live_rows + P sorted rows is exact; a batch whose live
        rows overflow falls back to the full-length stages via lax.cond).
        plan_version: static cache-buster — it must change whenever
        self.layers is rebuilt (continuation-cap calibration) so jit
        retraces against the new plans.

        Returns (accum', dropped_w, seg_count, live_counts[R],
        cont_demand[L-1]) — the counts feed host-side calibration.
        """
        contribs, landed_add, dropped_w, seg_count, cont_demand, slot_mass = (
            self._trace_batch_impl(batch_base, batch_counter, n_active, base_hi)
        )
        method = self.fold_kind
        n_classes = len(self.color_classes)
        landed = accum[-1] + landed_add
        basis_fn = partial(self._xyz_basis, batch_counter=batch_counter)
        xyz_acc = list(accum[:-1])
        live_counts = []
        for r, (pix, w, wl_idx, mask) in enumerate(contribs):
            P = xyz_acc[r].shape[0]
            if method != "sort":
                live_counts.append(jnp.sum((w > 0.0).astype(jnp.uint32)))

                def fold_other(acc, pix=pix, w=w, wl_idx=wl_idx, mask=mask):
                    vals = self._expand_vals(w, wl_idx, mask, batch_counter)
                    return accum_mod.accumulate(
                        acc, pix, vals,
                        method="sort" if method == "sort-legacy" else method,
                    )

                xyz_acc[r] = fold_other(xyz_acc[r])
                continue

            key, wz = accum_mod.pack_spectral_keys(pix, w, wl_idx, P, self.k_pool)
            live = jnp.sum((wz > 0.0).astype(jnp.uint32))
            live_counts.append(live)
            if n_classes:
                mask = jnp.where(key != jnp.uint32(0xFFFFFFFF), mask, 0)

            def fold(acc, key=key, wz=wz, mask=mask):
                return accum_mod.fold_spectral_keys(
                    acc, key, wz, self.k_pool, basis_fn,
                    lane_specs=tuple(self.color_classes),
                    mask=mask if n_classes else None,
                )

            kr = keep[r] if keep is not None else None
            if kr is None:
                xyz_acc[r] = fold(xyz_acc[r])
            else:
                # Compaction prepass: block-local sort of the live rows to
                # the front, so the fold's global sort runs on keep + P
                # rows instead of n_rows + P.
                cols = [wz] + ([mask] if n_classes else [])
                compacted, _n_valid = accum_mod.compact_by_key(key, cols, kr)

                def fold_prefix(acc, compacted=compacted):
                    ck, cw = compacted[0], compacted[1]
                    cm = compacted[2] if n_classes else None
                    return accum_mod.fold_spectral_keys(
                        acc, ck, cw, self.k_pool, basis_fn,
                        lane_specs=tuple(self.color_classes),
                        mask=cm,
                    )

                xyz_acc[r] = jax.lax.cond(
                    live <= jnp.uint32(kr), fold_prefix, fold, xyz_acc[r]
                )
        return (
            tuple(xyz_acc) + (landed,), dropped_w, seg_count,
            jnp.stack(live_counts), cont_demand, slot_mass,
        )

    # ------------------------------------------------------------------
    # Host loop
    # ------------------------------------------------------------------

    def _multi_step_impl(self, accum, counter0, n_steps: int, keep=None,
                         plan_version: int = 0):
        """`n_steps` batches in ONE device execution (fori_loop over the
        fused step; per-dispatch latency amortizes across all of them)."""
        stride = self.batch_size * max(1, len(self.layers) + 1)
        n_renders = len(self.proj_plans)
        n_bounds = max(0, len(self.layers) - 1)

        def body(i, carry):
            acc, dropped, segs, live, cont, sm = carry
            counter = counter0 + jnp.uint32(i)
            # Full 64-bit ray base (counter * stride) as (lo, hi) words —
            # the hi epoch feeds the per-ray seed mix (trace_backend.hpp:
            # 160-190; streams must not repeat past 2^32 rays).
            base_lo, base_hi = rng.mul_u32_split(counter, stride)
            acc, d, s, lv, cd, m = self._step_impl(
                acc, base_lo, counter, keep, plan_version, None, base_hi
            )
            return (acc, dropped + d, segs + s, live + lv, cont + cd, sm + m)

        carry = (accum, jnp.float32(0.0), jnp.uint32(0),
                 jnp.zeros((n_renders,), jnp.uint32),
                 jnp.zeros((n_bounds,), jnp.uint32),
                 jnp.zeros((self.max_hits,), jnp.float32))
        return jax.lax.fori_loop(0, n_steps, body, carry)

    def run(self, total_rays: Optional[int] = None, n_batches: Optional[int] = None) -> Stats:
        tail = 0
        if n_batches is None:
            total = int(total_rays if total_rays is not None else self.cfg.scene.ray_num)
            n_batches = max(1, -(-total // self.batch_size))
            # Exact ray budget (server.cpp:1477-1495): the remainder batch
            # traces only `tail` live lanes (the rest start at weight 0).
            tail = total - (n_batches - 1) * self.batch_size
            if tail == self.batch_size or n_batches * self.batch_size == total:
                tail = 0
            rays_requested = total
        else:
            rays_requested = n_batches * self.batch_size
        done = 0
        while done < n_batches:
            k = min(self.steps_per_dispatch, n_batches - done)
            keep = self._compact_keep
            is_tail = tail and done + k == n_batches
            if is_tail and k > 1:
                k -= 1          # full batches now, the tail alone next
                is_tail = False
            if k == 1:
                base = (self.batch_counter * self.batch_size
                        * max(1, len(self.layers) + 1))
                self.accum, dropped, segs, live, cont, smass = self._step(
                    self.accum,
                    jnp.uint32(base & 0xFFFFFFFF),
                    jnp.uint32(self.batch_counter),
                    keep,
                    self._plan_version,
                    jnp.uint32(tail) if is_tail else None,
                    jnp.uint32((base >> 32) & 0xFFFFFFFF),
                )
            else:
                self.accum, dropped, segs, live, cont, smass = self._multi_step(
                    self.accum, jnp.uint32(self.batch_counter), k, keep,
                    self._plan_version,
                )
            self.batch_counter += k
            done += k
            # Keep per-batch counters device-side: a float() here would
            # force a blocking device->host sync every batch (fatal over a
            # high-latency device link); stats reads drain lazily.
            self._pending_dropped.append(dropped)
            self._pending_segments.append(segs)
            if not self._calibrated and not is_tail:
                self._maybe_calibrate(live, cont, k, smass)
        self.stats = self.stats._replace(
            rays_traced=self.stats.rays_traced + rays_requested,
            stochastic_crystal_samples=self.stats.stochastic_crystal_samples
            + n_batches * sum(
                k
                for plan in self.layers
                for k, det in zip(plan.k_per_setting, plan.deterministic_shape)
                if not det
            ),
            stochastic_orientation_samples=self.stats.stochastic_orientation_samples
            + n_batches * sum(
                c
                for plan in self.layers
                for c, det in zip(plan.setting_counts, plan.deterministic_axis)
                if not det
            ),
        )
        return self.stats

    def _maybe_calibrate(self, live, cont, n_steps: int, slot_mass=None) -> None:
        """One-shot runtime calibration from the first dispatch's measured
        counts (one host sync).

        1. Continuation capacities: the plan heuristic over-provisions
           per-layer lane buffers; trim them to 1.25x the measured demand
           (never grow — overflow still drops lowest-weight rows with
           accounting). A trim rebuilds the plans and bumps _plan_version
           so the jitted step retraces.
        2. Dead-row fold compaction: pays when well under ~60% of
           contribution rows are live (the prepass costs one extra block
           rowsort); margin _KEEP_MARGIN absorbs per-batch Monte-Carlo
           fluctuation, and an overflowing batch falls back to the
           uncompacted fold inside the step (lax.cond), so a bad
           calibration costs speed, never correctness.

        Both are deterministic functions of (scene, seed, batch size, first
        dispatch size), so equal runs stay bit-comparable.
        """
        self._calibrated = True
        if self._slot_cap is None and slot_mass is not None:
            # Exit-slot cap: smallest cap whose dropped per-ray live-rank
            # tail is under 1e-4 of emitted mass (indistinguishable from
            # Monte-Carlo noise at any realistic ray budget; still honestly
            # accounted into dropped_cont_weight every batch). A cap that
            # saves no rows stays at H (no retrace churn).
            m = np.asarray(slot_mass, np.float64)
            total = float(m.sum())
            H = self.max_hits
            cap = H
            if total > 0:
                tail = np.cumsum(m[::-1])[::-1]        # tail[c] = mass at rank >= c
                for c in range(1, H):
                    if tail[c] <= 1e-4 * total:
                        cap = c
                        break
            self._slot_cap = cap
            if cap < H:
                self._recompute_rows_per_render()
                self._plan_version += 1
                from ice_halo_sim_jax.utils.log import get_logger

                get_logger("engine").info(
                    "slot cap calibrated: %d of %d exit slots "
                    "(tail mass %.2e of total)", cap, H,
                    float(tail[cap] / total) if total > 0 else 0.0,
                )
        elif self._slot_cap is None:
            self._slot_cap = self.max_hits
        cont_avg = np.asarray(cont, np.float64) / max(1, n_steps)
        if len(cont_avg):
            caps = [None]
            changed = False
            for li in range(1, len(self.layers)):
                cur = len(self.layers[li].setting_idx)
                want = int(cont_avg[li - 1] * 1.25)
                if want < 0.85 * cur:
                    caps.append(want)
                    changed = True
                else:
                    caps.append(None)
            if changed:
                self._build_plan(cont_caps=caps)
                self._recompute_rows_per_render()
                self._plan_version += 1

        if not self._compact_enabled:
            return
        if self.fold_kind != "sort":
            return
        live_avg = np.asarray(live, np.float64) / max(1, n_steps)
        block = accum_mod.BLOCK
        keep = []
        for r, n_rows in enumerate(self._rows_per_render):
            # Live-row prefix (with Monte-Carlo margin) the compaction
            # prepass keeps; the global fold sort then runs on keep + P
            # rows. Worth the extra block sort only when it meaningfully
            # shortens the global sort.
            target = int(np.ceil(live_avg[r] * self._KEEP_MARGIN / block)) * block
            if n_rows >= 2 * block and target <= 0.6 * n_rows:
                keep.append(max(block, target))
            else:
                keep.append(None)
        # All-None must stay literal None: it is a jit static argument, and
        # (None, ...) would needlessly recompile the identical program.
        self._compact_keep = (
            tuple(keep) if any(k is not None for k in keep) else None
        )

    def drain_stats(self) -> Stats:
        """Fold pending device-side counters into stats (one sync)."""
        if self._pending_dropped:
            total = float(np.sum([np.asarray(d) for d in self._pending_dropped]))
            self._pending_dropped = []
            self.stats = self.stats._replace(
                dropped_cont_weight=self.stats.dropped_cont_weight + total
            )
        if self._pending_segments:
            segs = int(np.sum([np.asarray(s, np.int64) for s in self._pending_segments]))
            self._pending_segments = []
            self.stats = self.stats._replace(
                ray_segments=self.stats.ray_segments + segs
            )
        # landed_weight is cumulative in the accumulator itself.
        self.stats = self.stats._replace(
            landed_weight=float(np.asarray(self.accum[-1]).sum())
        )
        return self.stats

    def snapshot(self):
        """Render current accumulators to uint8 sRGB images (one per render).

        Mirrors PrepareSnapshot + PostSnapshot (render.cpp:465-578)."""
        images = []
        landed = np.asarray(self.accum[-1])
        for r, (pplan, rcfg) in enumerate(zip(self.proj_plans, self.cfg.renders)):
            xyz = np.asarray(self.accum[r][:, :3]).reshape(pplan.height, pplan.width, 3)
            use_real = rcfg.ray_color[0] < 0
            img = color.post_process(
                jnp.asarray(xyz),
                rcfg.intensity_factor,
                float(landed[r]),
                rcfg.background,
                rcfg.ray_color,
                use_real_color=use_real,
            )
            images.append(np.asarray(img))
        return images

    def raw_xyz(self, render_idx: int = 0) -> np.ndarray:
        p = self.proj_plans[render_idx]
        return np.asarray(self.accum[render_idx][:, :3]).reshape(p.height, p.width, 3)

    def lane_y(self, render_idx: int = 0) -> Optional[np.ndarray]:
        """Raw per-color-class Y lanes [C, H, W] for one renderer."""
        if not self.color_classes:
            return None
        p = self.proj_plans[render_idx]
        arr = np.asarray(self.accum[render_idx][:, 3:])          # [P, C]
        return arr.T.reshape(len(self.color_classes), p.height, p.width)

    def composite(self, render_idx: int = 0, display_exposure_scale: float = 1.0):
        """Color-class composite image (linear RGB [H, W, 3]) or None."""
        from ice_halo_sim_jax.engine.compositor import composite_color_classes

        lanes = self.lane_y(render_idx)
        if lanes is None or self.cfg.raypath_color is None:
            return None
        rcfg = self.cfg.renders[render_idx]
        return composite_color_classes(
            lanes,
            self.cfg.raypath_color.classes,
            self.cfg.raypath_color.composite_mode,
            intensity_factor=rcfg.intensity_factor,
            display_exposure_scale=display_exposure_scale,
        )

"""Multi-device execution: rays sharded over a device mesh.

The reference is single-node (SURVEY §2.9): its only parallel dimensions are
data-parallel rays across worker threads and a single-GPU megakernel. The
mapping here is a flat 1-D `rays` mesh axis: every card runs the SAME fused
batch step on its own ray shard with its own device-resident XYZ accumulator
(no cross-card traffic during tracing — rays are embarrassingly parallel),
and accumulators are reduced across cards only at drain time, the
reference's third-clock drain cadence applied to a mesh. Every card of a
host reaches every other at the same NVLink rate, so the mesh follows the
algorithm alone.

RNG correctness across shards follows the reference's counter-based design:
each device offsets its global ray indices by `axis_index * shard_span`, so
streams never collide (the SplitPcgRayBase lesson, trace_backend.hpp:160-190).

There is deliberately no TP/PP/EP here — a Monte-Carlo renderer has no
parameter or layer dimension to shard; faking one would add collectives to a
workload whose scaling law is embarrassingly parallel (SURVEY §5).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ice_halo_sim_jax.config.schema import ProjectConfig
from ice_halo_sim_jax.engine.simulator import DEFAULT_GEOM_CLOCK, Engine


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("rays",))


class ShardedEngine:
    """Data-parallel engine: per-device batches + psum-at-drain accumulators."""

    def __init__(self, cfg: ProjectConfig, mesh: Optional[Mesh] = None, seed: int = 1,
                 per_device_batch: int = 1 << 17, geom_clock: int = DEFAULT_GEOM_CLOCK,
                 accum_method: str = "auto", calibrate: bool = True):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_dev = self.mesh.devices.size
        # The inner engine is sized per device; its jitted step becomes the
        # shard_map body.
        self.engine = Engine(cfg, seed=seed, batch_size=per_device_batch,
                             geom_clock=geom_clock, accum_method=accum_method)
        if calibrate:
            # Single-device pre-calibration: ONE dispatch through the
            # inner engine's normal path calibrates the exit-slot cap and
            # the fold's compaction keep from measured counts — all
            # deterministic functions of (scene, seed, per-device batch),
            # so every run and every shard agrees. reset() discards the
            # calibration accumulators but keeps the calibrated plan, which
            # the shard_map step closes over below.
            self.engine.run(n_batches=1)
            self.engine.reset()
            self._assert_calibration_agreement()
        else:
            # Uncapped, uncompacted fold: exact by construction; cap/keep
            # only trim fold rows for speed.
            if self.engine._slot_cap is None:
                self.engine._slot_cap = self.engine.max_hits
            self.engine._calibrated = True
        self.cfg = cfg
        self.per_device_batch = per_device_batch
        self.batch_counter = 0
        # Global ray-index span one device consumes per batch (engine.run uses
        # B * (n_layers + 1) slots per batch for layer-continuation streams).
        self.span = per_device_batch * (len(self.engine.layers) + 1)

        n_dev = self.n_dev
        span = self.span
        # Calibrated fold parameters, frozen into the sharded step (static
        # jit arguments of the inner step).
        keep = self.engine._compact_keep
        plan_version = self.engine._plan_version

        def sharded_step(accum, batch_base, batch_counter, base_hi):
            from ice_halo_sim_jax.core import rng

            dev = jax.lax.axis_index("rays").astype(jnp.uint32)
            # Full 64-bit per-device ray base: the hi word feeds the
            # per-ray seed epoch mix (trace_backend.hpp:160-190) — on a
            # mesh the global index space is consumed n_dev x faster, so
            # the 2^32 stream wrap arrives proportionally sooner.
            off_lo, off_hi = rng.mul_u32_split(dev, span)
            local_base = batch_base + off_lo
            carry = (local_base < batch_base).astype(jnp.uint32)
            local_hi = base_hi + off_hi + carry
            local_accum = jax.tree.map(lambda a: a[0], accum)
            new_accum, dropped, segs, _live, _cont, _sm = self.engine._step_impl(
                local_accum, local_base, batch_counter,
                keep, plan_version, None, local_hi,
            )
            return (
                jax.tree.map(lambda a: a[None], new_accum),
                jax.lax.psum(dropped, "rays"),
                jax.lax.psum(segs, "rays"),
            )

        acc_specs = tuple(P("rays") for _ in self.engine.accum)
        self._step = jax.jit(
            jax.shard_map(
                sharded_step,
                mesh=self.mesh,
                in_specs=(acc_specs, P(), P(), P()),
                out_specs=(acc_specs, P(), P()),
            ),
            donate_argnums=(0,),
        )

        def drain(accum):
            return jax.tree.map(lambda a: jnp.sum(a, axis=0), accum)

        # Replicated output: every process can then read the drained image
        # locally (np.asarray needs full addressability).
        self._drain = jax.jit(
            drain, out_shardings=NamedSharding(self.mesh, P())
        )
        self.reset()

    def _calibration_digest(self) -> np.ndarray:
        """Flat int64 digest of every calibrated static plan parameter the
        shard_map step freezes in: slot cap, plan version, per-render keep
        budgets and continuation capacities."""
        eng = self.engine
        parts = [eng._slot_cap or -1, eng._plan_version]
        keep = eng._compact_keep or ()
        parts += [(-1 if k is None else k) for k in keep]
        parts += [len(p.setting_idx) for p in eng.layers]
        # Fixed length so process_allgather never shape-mismatches even
        # when the structural plans themselves diverged.
        out = np.zeros(64, np.int64)
        out[: min(64, len(parts))] = parts[:64]
        out[-1] = len(parts)
        return out

    def _assert_calibration_agreement(self) -> None:
        """On a multi-process runtime, verify every process calibrated the
        SAME static plan: calibration is a deterministic
        function of (scene, seed, batch size), but a heterogeneous device
        fleet or backend nondeterminism would yield divergent SPMD programs
        that hang or corrupt silently instead of erroring. One tiny
        all-gather at startup turns that into a clear failure."""
        if jax.process_count() <= 1:
            return
        from jax.experimental import multihost_utils

        digest = self._calibration_digest()
        gathered = np.asarray(
            multihost_utils.process_allgather(digest)
        ).reshape(jax.process_count(), -1)
        if not (gathered == gathered[0]).all():
            raise RuntimeError(
                "calibrated plans diverged across processes: "
                f"{gathered.tolist()} — heterogeneous local devices or "
                "nondeterministic calibration counts; pin IHT_SLOT_CAP / "
                "IHT_COMPACT=0 or use calibrate=False"
            )

    def reset(self) -> None:
        shard = NamedSharding(self.mesh, P("rays"))
        # make_array_from_callback builds each process's addressable shards
        # locally — works identically on a single-process mesh and on a
        # multi-host (multi-controller) mesh, where device_put of a global
        # array would fail on non-addressable devices.
        self.accum = tuple(
            jax.make_array_from_callback(
                (self.n_dev,) + a.shape,
                shard,
                lambda idx, a=a: np.zeros(
                    (1,) + a.shape, a.dtype
                ),
            )
            for a in self.engine.accum
        )
        self.batch_counter = 0
        self.dropped_weight = 0.0
        self.ray_segments = 0

    def run(self, n_batches: int = 1):
        # Per-batch counters accumulate EVERY iteration (reassigning and
        # folding once after the loop undercounted by (n-1)/n). Kept
        # device-side until the loop ends: one sync total.
        pend_dropped, pend_segs = [], []
        for _ in range(n_batches):
            base64 = self.batch_counter * self.n_dev * self.span
            self.accum, dropped, segs = self._step(
                self.accum, jnp.uint32(base64 & 0xFFFFFFFF),
                jnp.uint32(self.batch_counter),
                jnp.uint32((base64 >> 32) & 0xFFFFFFFF),
            )
            pend_dropped.append(dropped)
            pend_segs.append(segs)
            self.batch_counter += 1
        self.dropped_weight += float(np.sum([np.asarray(d) for d in pend_dropped]))
        self.ray_segments += int(np.sum([np.asarray(s, np.int64) for s in pend_segs]))
        return self

    @property
    def rays_traced(self) -> int:
        return self.batch_counter * self.n_dev * self.per_device_batch

    def drained_accum(self):
        """Cross-device reduced accumulators (reduced at drain cadence)."""
        return self._drain(self.accum)

    def _dense_xyz(self, drained, r: int) -> np.ndarray:
        """Dense [H, W, 3] image from drained accumulators."""
        p = self.engine.proj_plans[r]
        return np.asarray(drained[r][:, :3]).reshape(p.height, p.width, 3)

    def raw_xyz(self, render_idx: int = 0) -> np.ndarray:
        return self._dense_xyz(self.drained_accum(), render_idx)

    def snapshot(self):
        from ice_halo_sim_jax.core import color

        drained = self.drained_accum()
        landed = np.asarray(drained[-1])
        images = []
        for r, (pplan, rcfg) in enumerate(zip(self.engine.proj_plans, self.cfg.renders)):
            xyz = self._dense_xyz(drained, r)
            img = color.post_process(
                jnp.asarray(xyz), rcfg.intensity_factor, float(landed[r]),
                rcfg.background, rcfg.ray_color,
                use_real_color=rcfg.ray_color[0] < 0,
            )
            images.append(np.asarray(img))
        return images

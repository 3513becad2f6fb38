"""Checkpoint / resume for the render accumulation.

The reference has NO simulation-state persistence — accumulation is
in-memory and a config change resets it (SURVEY.md section 5; reference
RenderConsumer::Reset, render.cpp:601-616). Because our accumulators are
explicit JAX arrays, checkpointing is a straight serialization of
{config JSON, seed, batch counter, accumulators, stats} — an improvement
the array formulation gets nearly for free.

Format: a single .npz with a JSON header entry; stable across processes
and platforms (host numpy arrays only).
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.loader import load_project
from ice_halo_sim_jax.config.serialize import project_to_dict
from ice_halo_sim_jax.engine.simulator import Engine, Stats

FORMAT_VERSION = 1


def save_checkpoint(path: str, engine: Engine) -> None:
    """Serialize the engine's full resumable state to ``path`` (.npz)."""
    stats = engine.drain_stats()  # fold pending device counters first
    header = {
        "format_version": FORMAT_VERSION,
        "project": project_to_dict(engine.cfg),
        "seed": engine.seed,
        "batch_size": engine.batch_size,
        "geom_clock": engine.geom_clock,
        "batch_counter": engine.batch_counter,
        "stats": stats._asdict(),
        "n_accum": len(engine.accum),
        # Calibration state that affects VALUES, not just speed: the slot
        # cap changes which (negligible, accounted) exit rows accumulate,
        # so a resumed engine must reuse the saved cap instead of
        # recalibrating from a different dispatch (bit-exact resume).
        "slot_cap": engine._slot_cap,
    }
    arrays = {f"accum_{i}": np.asarray(a) for i, a in enumerate(engine.accum)}
    np.savez_compressed(path, header=json.dumps(header), **arrays)


def load_checkpoint(path: str) -> Engine:
    """Rebuild an Engine from a checkpoint; resumes exactly where saved
    (same RNG stream position via the restored batch counter)."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(str(data["header"]))
        if header["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header['format_version']} != {FORMAT_VERSION}"
            )
        cfg = load_project(header["project"])
        engine = Engine(
            cfg,
            seed=header["seed"],
            batch_size=header["batch_size"],
            geom_clock=header["geom_clock"],
        )
        accum = tuple(
            jnp.asarray(data[f"accum_{i}"]) for i in range(header["n_accum"])
        )
        if len(accum) != len(engine.accum):
            raise ValueError("checkpoint accumulator count mismatch")
        for saved, fresh in zip(accum, engine.accum):
            if saved.shape != fresh.shape:
                raise ValueError(
                    f"checkpoint accumulator shape {saved.shape} != {fresh.shape}"
                )
        engine.accum = accum
        engine.batch_counter = int(header["batch_counter"])
        engine.stats = Stats(**header["stats"])
        if header.get("slot_cap") is not None:
            engine._slot_cap = int(header["slot_cap"])
            engine._recompute_rows_per_render()
    return engine

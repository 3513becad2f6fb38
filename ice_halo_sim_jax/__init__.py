"""Differentiable Monte-Carlo ice-halo renderer in JAX.

A JAX/XLA framework with the capabilities of
LoveDaisy/ice_halo_sim ("Lumice"): sunlight traced through ensembles of
randomly-oriented hexagonal ice crystals (prisms / pyramids), Snell
refraction / Fresnel reflection with wavelength-dependent ice IOR, ray-path
filters with P/B/D crystal-symmetry folding, 11 lens projections into a
spectral CIE-XYZ accumulator, and sRGB tone mapping — all expressed as
batched fixed-shape JAX programs so the image is differentiable and shards
across GPU device meshes.

This is NOT a port of the C++ core: rays live in fixed-size SoA arrays with
live masks, the bounce loop is a fused single-path weighted trace (the
formulation the reference uses on its GPU backends,
/root/reference/src/core/backend/cuda_trace_backend.cu:603-1219), and
accumulation is per-shard scatter-add + psum instead of queues and atomics.
"""

__version__ = "0.1.0"

from ice_halo_sim_jax.config.loader import load_project, load_project_file  # noqa: F401
from ice_halo_sim_jax.config.serialize import project_to_dict, project_to_json  # noqa: F401
from ice_halo_sim_jax.config.builder import SceneBuilder  # noqa: F401


def __getattr__(name):
    """Lazy heavyweight entry points (importing them pulls in JAX)."""
    if name == "Engine":
        from ice_halo_sim_jax.engine.simulator import Engine

        return Engine
    if name == "Server":
        from ice_halo_sim_jax.engine.server import Server

        return Server
    if name in ("save_checkpoint", "load_checkpoint"):
        from ice_halo_sim_jax.engine import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

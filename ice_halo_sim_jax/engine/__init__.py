from ice_halo_sim_jax.engine.simulator import Engine  # noqa: F401

from ice_halo_sim_jax.parallel.sharding import ShardedEngine, make_mesh  # noqa: F401

from ice_halo_sim_jax.config import schema  # noqa: F401
from ice_halo_sim_jax.config.loader import load_project, load_project_file  # noqa: F401

"""Where the persistent compilation cache lives."""

import os
import subprocess
import sys

import jax

from ice_halo_sim_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_checkout_dot_jax_cache():
    saved = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_env_var_wins_and_nothing_else_is_set(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"),
               JAX_PLATFORMS="cpu")
    code = (
        "import jax; from ice_halo_sim_jax.utils.compile_cache import "
        "enable_compile_cache as e; print(e()); "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines == [str(tmp_path / "c")] * 2

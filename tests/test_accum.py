"""Accumulation-strategy tests: sort_accumulate must equal scatter-add."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ice_halo_sim_jax.core.accum import (
    accumulate,
    scatter_accumulate,
    sort_accumulate,
)


def _check(pix, vals, P, chunk=64):
    C = vals.shape[1]
    acc = jnp.zeros((P, C))
    ref = scatter_accumulate(acc, pix, vals)
    out = sort_accumulate(acc, pix, vals, chunk=chunk)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=1e-4, atol=1e-4
    )


def test_random_dense():
    rng = np.random.default_rng(0)
    pix = jnp.asarray(rng.integers(0, 500, size=4096), jnp.int32)
    vals = jnp.asarray(rng.uniform(0, 2, size=(4096, 3)), jnp.float32)
    _check(pix, vals, 500)


def test_all_same_pixel_spans_many_chunks():
    # One group spanning dozens of chunks exercises the carry chain.
    pix = jnp.full((4096,), 7, jnp.int32)
    vals = jnp.ones((4096, 2), jnp.float32)
    P = 16
    out = sort_accumulate(jnp.zeros((P, 2)), pix, vals, chunk=64)
    assert float(out[7, 0]) == 4096.0
    assert float(jnp.abs(out).sum()) == 2 * 4096.0


def test_empty_and_single_pixels():
    pix = jnp.asarray([3, 3, 9], jnp.int32)
    vals = jnp.asarray([[1.0], [2.0], [5.0]], jnp.float32)
    out = sort_accumulate(jnp.zeros((12, 1)), pix, vals, chunk=64)
    assert float(out[3, 0]) == 3.0
    assert float(out[9, 0]) == 5.0
    assert float(jnp.abs(out).sum()) == 8.0


def test_invalid_pixels_dropped():
    pix = jnp.asarray([-1, 2, 100, 2], jnp.int32)
    vals = jnp.ones((4, 1), jnp.float32)
    P = 8
    ref = scatter_accumulate(jnp.zeros((P, 1)), pix, vals)
    out = sort_accumulate(jnp.zeros((P, 1)), pix, vals, chunk=64)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref))
    assert float(out[2, 0]) == 2.0
    assert float(jnp.abs(out).sum()) == 2.0


def test_accumulates_onto_existing():
    acc = jnp.ones((6, 2))
    pix = jnp.asarray([0, 5], jnp.int32)
    vals = jnp.full((2, 2), 3.0)
    out = sort_accumulate(acc, pix, vals, chunk=64)
    assert float(out[0, 0]) == 4.0
    assert float(out[3, 0]) == 1.0


def test_zero_weight_contributions():
    pix = jnp.asarray([1, 1, 1], jnp.int32)
    vals = jnp.asarray([[0.0], [0.0], [7.0]], jnp.float32)
    out = sort_accumulate(jnp.zeros((4, 1)), pix, vals, chunk=64)
    assert float(out[1, 0]) == 7.0


def test_n_smaller_than_p_and_chunk_padding():
    # N + P not a chunk multiple; N << P.
    pix = jnp.asarray([777], jnp.int32)
    vals = jnp.asarray([[2.5, 0.5]], jnp.float32)
    out = sort_accumulate(jnp.zeros((1000, 2)), pix, vals, chunk=64)
    assert float(out[777, 0]) == 2.5
    assert float(jnp.abs(out).sum()) == 3.0


def test_jit_and_grad_safety():
    # jit-compiles with static shapes; not differentiated (accumulation is
    # outside the gradient path), but must not error under vmap-free jit.
    f = jax.jit(lambda a, p, v: accumulate(a, p, v, method="sort"))
    rng = np.random.default_rng(1)
    pix = jnp.asarray(rng.integers(0, 100, size=256), jnp.int32)
    vals = jnp.asarray(rng.uniform(0, 1, size=(256, 3)), jnp.float32)
    out = f(jnp.zeros((100, 3)), pix, vals)
    ref = scatter_accumulate(jnp.zeros((100, 3)), pix, vals)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_large_randomized_against_scatter():
    rng = np.random.default_rng(7)
    N, P = 1 << 15, 1 << 13
    pix = jnp.asarray(rng.integers(-5, P + 5, size=N), jnp.int32)
    vals = jnp.asarray(rng.exponential(1.0, size=(N, 4)), jnp.float32)
    _check(pix, vals, P, chunk=256)

"""fold_spectral must equal scatter-add of the expanded channels.

The spectral fold sorts (pixel<<log2(2K) | wl_idx<<1 | marker) keys with a
single weight payload and rebuilds the XYZ/lane channels post-sort; these
tests pin its equivalence to the dense reference on every edge the key
packing creates (invalid rows, pixel 0 / P-1, all-one-pixel, empty input,
lane masks, k_pool=1).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ice_halo_sim_jax.core.accum import fold_spectral, spectral_key_bits


def _basis_fn(idx):
    # Nonnegative, like real CMFs (fold_spectral requires vals >= 0).
    i = idx.astype(jnp.float32)
    return jnp.stack([0.5 + 0.1 * i, 1.0 + 0.05 * i, 2.0 + 0.02 * i], axis=-1)


def _dense_ref(P, L, pix, w, idx, mask, lane_specs):
    ref = np.zeros((P, 3 + L), np.float32)
    b = np.asarray(_basis_fn(jnp.asarray(idx)))
    for n in range(len(pix)):
        p = int(pix[n])
        if 0 <= p < P and w[n] > 0:
            ref[p, :3] += b[n] * w[n]
            y = b[n, 1] * w[n]
            for li, (bits, call) in enumerate(lane_specs):
                m = int(mask[n]) & bits
                if (m == bits) if call else (m != 0):
                    ref[p, 3 + li] += y
    return ref


@pytest.mark.parametrize("k_pool", [1, 16, 256])
@pytest.mark.parametrize("chunk", [64, 1024])
def test_matches_scatter_reference(k_pool, chunk):
    rng = np.random.default_rng(7)
    P, N = 777, 4096
    pix = rng.integers(-3, P + 3, N).astype(np.int32)
    w = np.abs(rng.standard_normal(N)).astype(np.float32)
    w[rng.random(N) < 0.1] = 0.0
    idx = rng.integers(0, k_pool, N).astype(np.uint32)
    mask = rng.integers(0, 16, N).astype(np.uint32)
    lane_specs = ((0b0011, False), (0b0101, True))

    out = fold_spectral(
        jnp.zeros((P, 5), jnp.float32), jnp.asarray(pix), jnp.asarray(w),
        jnp.asarray(idx), k_pool, _basis_fn, lane_specs, jnp.asarray(mask),
        chunk=chunk,
    )
    ref = _dense_ref(P, 2, pix, w, idx, mask, lane_specs)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-3)


def test_no_lanes_and_accumulates_into_acc():
    rng = np.random.default_rng(3)
    P, N, K = 64, 512, 8
    pix = rng.integers(0, P, N).astype(np.int32)
    w = rng.random(N).astype(np.float32)
    idx = rng.integers(0, K, N).astype(np.uint32)
    acc0 = jnp.full((P, 3), 2.5, jnp.float32)
    out = fold_spectral(acc0, jnp.asarray(pix), jnp.asarray(w),
                        jnp.asarray(idx), K, _basis_fn, chunk=64)
    ref = 2.5 + _dense_ref(P, 0, pix, w, idx, np.zeros(N, np.uint32), ())
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-3)


def test_edge_pixels_and_all_one_pixel():
    P, K = 100, 4
    for target in (0, P - 1):
        pix = np.full(300, target, np.int32)
        w = np.ones(300, np.float32)
        idx = np.zeros(300, np.uint32)
        out = fold_spectral(jnp.zeros((P, 3)), jnp.asarray(pix), jnp.asarray(w),
                            jnp.asarray(idx), K, _basis_fn, chunk=64)
        out = np.asarray(out)
        np.testing.assert_allclose(out[target], [150.0, 300.0, 600.0], rtol=1e-5)
        rest = np.delete(out, target, axis=0)
        assert np.abs(rest).max() == 0.0


def test_all_invalid_rows_add_nothing():
    P, K = 50, 16
    out = fold_spectral(
        jnp.zeros((P, 3)), jnp.full(128, -1, jnp.int32), jnp.ones(128),
        jnp.zeros(128, jnp.uint32), K, _basis_fn, chunk=64,
    )
    assert float(jnp.abs(out).max()) == 0.0
    # out-of-range high side too
    out = fold_spectral(
        jnp.zeros((P, 3)), jnp.full(128, P, jnp.int32), jnp.ones(128),
        jnp.zeros(128, jnp.uint32), K, _basis_fn, chunk=64,
    )
    assert float(jnp.abs(out).max()) == 0.0


def test_key_bits_guard():
    assert spectral_key_bits(2048 * 1024, 512)
    assert not spectral_key_bits(1 << 24, 512)
    # the off-by-one: invalid key 0xFFFFFFFF must decode past the last pixel
    assert not spectral_key_bits((1 << 31) // 512, 512)


def test_compact_rows_preserves_valid_set():
    from ice_halo_sim_jax.core.accum import compact_rows

    rng = np.random.default_rng(11)
    N = 70000  # several blocks plus a ragged tail
    w = np.where(rng.random(N) < 0.3, rng.random(N).astype(np.float32), 0.0)
    pix = rng.integers(0, 1000, N).astype(np.int32)
    idx = rng.integers(0, 8, N).astype(np.uint32)
    valid = w > 0
    keep = (int(valid.sum() * 1.3) // 16384 + 1) * 16384

    (cp, cw, ci), n_valid = compact_rows(
        jnp.asarray(valid), [jnp.asarray(pix), jnp.asarray(w), jnp.asarray(idx)], keep
    )
    cp, cw, ci = np.asarray(cp), np.asarray(cw), np.asarray(ci)
    assert int(n_valid) == int(valid.sum())
    # The multiset of valid (pix, w, idx) rows must be preserved exactly,
    # and every other output row must carry zero weight.
    got = sorted(zip(cp[cw > 0].tolist(), cw[cw > 0].tolist(), ci[cw > 0].tolist()))
    want = sorted(zip(pix[valid].tolist(), w[valid].tolist(), idx[valid].tolist()))
    assert got == want


def test_compact_rows_zeroes_invalid_payloads():
    """Invalid rows carrying NONZERO payloads must not leak through the
    last block's un-overwritten suffix: a caller whose "invalid" rows carry
    w > 0 would otherwise double-count the leaked tail."""
    from ice_halo_sim_jax.core.accum import BLOCK, compact_rows

    rng = np.random.default_rng(5)
    N = 3 * BLOCK  # exact block multiple: the tail IS the last block
    w = rng.uniform(0.5, 1.0, N).astype(np.float32)  # every row has mass
    pix = rng.integers(0, 1000, N).astype(np.int32)
    valid = rng.random(N) < 0.25  # last block keeps a large invalid suffix
    keep = N

    (cp, cw), n_valid = compact_rows(
        jnp.asarray(valid), [jnp.asarray(pix), jnp.asarray(w)], keep
    )
    cp, cw = np.asarray(cp), np.asarray(cw)
    assert int(n_valid) == int(valid.sum())
    got = sorted(zip(cp[cw > 0].tolist(), cw[cw > 0].tolist()))
    want = sorted(zip(pix[valid].tolist(), w[valid].tolist()))
    assert got == want  # no invalid row's weight survives anywhere
    assert float(cw.sum()) == pytest.approx(float(w[valid].sum()), rel=1e-6)


def test_compact_rows_overflow_reports_true_count():
    from ice_halo_sim_jax.core.accum import compact_rows

    valid = np.ones(40000, bool)
    w = np.ones(40000, np.float32)
    (cw,), n_valid = compact_rows(jnp.asarray(valid), [jnp.asarray(w)], 16384)
    assert int(n_valid) == 40000  # caller must fall back: keep < n_valid
    assert np.asarray(cw).shape == (16384,)

"""Color pipeline tests: CMF lookup, illuminants, sRGB post-processing."""

import numpy as np
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.core import color


def test_cmf_lookup_rounding_and_range():
    # 555 nm is near the photopic peak; y ~ 1.0.
    xyz = np.asarray(color.cmf_lookup(jnp.asarray([555.0])))
    assert xyz[0, 1] > 0.99
    # Rounding: 554.6 -> 555.
    xyz2 = np.asarray(color.cmf_lookup(jnp.asarray([554.6])))
    np.testing.assert_array_equal(xyz, xyz2)
    # Out of range -> zeros.
    assert np.asarray(color.cmf_lookup(jnp.asarray([359.0, 831.0]))).sum() == 0.0
    # Blue wavelength dominated by z, red by x.
    b = np.asarray(color.cmf_lookup(jnp.asarray([450.0])))[0]
    r = np.asarray(color.cmf_lookup(jnp.asarray([650.0])))[0]
    assert b[2] > b[0] > b[1]
    assert r[0] > r[1] > r[2]


def test_d65_spd():
    wl = jnp.asarray([450.0, 560.0, 700.0])
    spd = np.asarray(color.illuminant_spd("D65", wl))
    # The CIE daylight reconstruction is ~100 at 560 nm by construction.
    assert spd[1] == pytest.approx(100.0, rel=0.02)
    assert (spd > 0).all()
    # E is flat 1.0 (illuminant.cpp:126-131).
    e = np.asarray(color.illuminant_spd("E", wl))
    np.testing.assert_allclose(e, 1.0)
    # A (2856 K blackbody) rises toward red.
    a = np.asarray(color.illuminant_spd("A", wl))
    assert a[2] > a[1] > a[0]
    assert a[1] == pytest.approx(100.0, rel=0.05)  # normalized near 560


def test_exposure_scale():
    assert color.exposure_scale(1.0, 100, 0.0) == 0.0
    assert color.exposure_scale(2.0, 1000, 50.0) == pytest.approx(2.0 * 0.08 * 1000 / 50.0)


def test_gamut_clip_identity_in_gamut():
    """In-gamut colors are unchanged; the D65 gray axis is a fixed point."""
    gray = jnp.asarray(color.WHITE_D65) * 0.5
    out = np.asarray(color.gamut_clip_xyz(gray[None]))
    np.testing.assert_allclose(out[0], np.asarray(gray), atol=1e-6)
    # An in-gamut color: mid gray with slight chroma.
    xyz = jnp.asarray([[0.4, 0.45, 0.5]])
    rgb = np.asarray(color.xyz_to_linear_rgb(xyz))
    assert (rgb > 0).all() and (rgb < 1).all()
    out = np.asarray(color.gamut_clip_xyz(xyz))
    np.testing.assert_allclose(out, np.asarray(xyz), atol=1e-5)


def test_gamut_clip_out_of_gamut():
    """A saturated spectral color (negative RGB) clips to gamut boundary with
    luminance preserved."""
    xyz_spectral = color.cmf_lookup(jnp.asarray([450.0]))  # deep blue
    raw_rgb = np.asarray(jnp.einsum("...k,jk->...j", xyz_spectral, jnp.asarray(color.XYZ_TO_RGB)))
    assert raw_rgb.min() < 0  # genuinely out of gamut
    clipped = color.gamut_clip_xyz(xyz_spectral)
    rgb = np.asarray(jnp.einsum("...k,jk->...j", clipped, jnp.asarray(color.XYZ_TO_RGB)))
    assert rgb.min() >= -1e-4
    assert float(clipped[0, 1]) == pytest.approx(float(xyz_spectral[0, 1]), rel=1e-5)


def test_srgb_gamma():
    assert float(color.linear_to_srgb(jnp.float32(0.0))) == pytest.approx(0.0)
    assert float(color.linear_to_srgb(jnp.float32(1.0))) == pytest.approx(1.0, abs=1e-6)
    assert float(color.linear_to_srgb(jnp.float32(0.001))) == pytest.approx(0.01292, rel=1e-4)
    assert float(color.linear_to_srgb(jnp.float32(0.5))) == pytest.approx(0.7354, rel=1e-3)


def test_post_process_shapes_and_monotonic():
    img = jnp.zeros((8, 10, 3), jnp.float32).at[4, 5].set(jnp.asarray([0.9, 1.0, 1.1]))
    out = np.asarray(color.post_process(img, 1.0, 1.0, (0, 0, 0), (-1, -1, -1)))
    assert out.shape == (8, 10, 3) and out.dtype == np.uint8
    assert out[4, 5].sum() > 0
    assert out[0, 0].sum() == 0
    # Double intensity factor never darkens.
    out2 = np.asarray(color.post_process(img, 2.0, 1.0, (0, 0, 0), (-1, -1, -1)))
    assert (out2.astype(int) >= out.astype(int)).all()
    # Background fills empty pixels.
    out3 = np.asarray(color.post_process(img, 1.0, 1.0, (0.25, 0.0, 0.0), (-1, -1, -1)))
    assert out3[0, 0, 0] > 0 and out3[0, 0, 1] == 0


def test_cmf_eval_matches_table_at_segment_edges():
    """cmf_eval gathers its Chebyshev segment by index; on the table's 1-nm
    grid points on both sides of every segment edge the fit must match the
    table to its documented residual (~1.5e-4 of peak)."""
    from ice_halo_sim_jax.core import color

    edges = np.linspace(color.CMF_WL_MIN, color.CMF_WL_MAX, color._CMF_NSEG + 1)
    wl = np.unique(np.clip(np.concatenate(
        [np.floor(edges) + d for d in (-1, 0, 1, 2)]),
        color.CMF_WL_MIN, color.CMF_WL_MAX))
    got = np.asarray(color.cmf_eval(jnp.asarray(wl, jnp.float32)))
    want = np.asarray(color.cmf_lookup(jnp.asarray(wl, jnp.float32)))
    assert np.abs(got - want).max() < 5e-4 * np.abs(want).max()
    assert (got >= 0).all()


def test_daylight_components_exact_at_table_nodes():
    from ice_halo_sim_jax.core import color

    n = color._DAYLIGHT_S.shape[1]
    wl = color._DAYLIGHT_WL_MIN + color._DAYLIGHT_WL_STEP * np.arange(n)
    got = np.asarray(color.daylight_components(jnp.asarray(wl, jnp.float32)))
    np.testing.assert_allclose(got, color._DAYLIGHT_S, rtol=1e-6, atol=1e-5)


def test_daylight_components_interpolate_between_nodes():
    from ice_halo_sim_jax.core import color

    s = np.asarray(color._DAYLIGHT_S, np.float64)
    n = s.shape[1]
    wl = (color._DAYLIGHT_WL_MIN + color._DAYLIGHT_WL_STEP * np.arange(n - 1)
          + 0.25 * color._DAYLIGHT_WL_STEP)
    got = np.asarray(color.daylight_components(jnp.asarray(wl, jnp.float32)))
    want = 0.75 * s[:, :-1] + 0.25 * s[:, 1:]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

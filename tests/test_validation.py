"""Raypath validation + env-knob registry tests
(reference: test/unit-correctness/config raypath validation suites)."""

import os

from ice_halo_sim_jax.config.validation import (
    ALL_LEGAL_FACES,
    CrystalKind,
    RaypathValidation,
    is_legal_face,
    parse_raypath,
    validate_raypath_text,
)
from ice_halo_sim_jax.utils import env_knobs


def test_legal_faces_per_kind():
    # basal + prism lateral on both kinds
    for f in (1, 2, 3, 8):
        assert is_legal_face(CrystalKind.PRISM, f)
        assert is_legal_face(CrystalKind.PYRAMID, f)
    # pyramid-only faces
    for f in (13, 18, 23, 28):
        assert not is_legal_face(CrystalKind.PRISM, f)
        assert is_legal_face(CrystalKind.PYRAMID, f)
    # never legal
    for f in (0, 9, 12, 19, 22, 29, 51):
        assert not is_legal_face(CrystalKind.PRISM, f)
        assert not is_legal_face(CrystalKind.PYRAMID, f)
    assert len(ALL_LEGAL_FACES) == 2 + 6 + 6 + 6


def test_raypath_text_syntax():
    V, I, N = (RaypathValidation.VALID, RaypathValidation.INCOMPLETE,
               RaypathValidation.INVALID)
    cases = {
        "": V, "3": V, "3-5": V, "3,5": V, "51": V,  # syntax-only: 51 ok
        "3-5-": I, "-3": I,
        "3--5": N, "--3": N, "a-3": N, "3-x": N,
    }
    for text, want in cases.items():
        state, _ = validate_raypath_text(text)
        assert state == want, f"{text!r}: {state} != {want}"


def test_raypath_text_kind_checks():
    state, msg = validate_raypath_text("3-51-5", CrystalKind.PRISM)
    assert state == RaypathValidation.INVALID
    assert "outside the legal range" in msg
    state, msg = validate_raypath_text("3-13-5", CrystalKind.PRISM)
    assert state == RaypathValidation.INVALID
    assert "not legal on this crystal type" in msg
    state, msg = validate_raypath_text("3-13-5", CrystalKind.PYRAMID)
    assert state == RaypathValidation.VALID
    assert msg == ""


def test_parse_raypath():
    assert parse_raypath("3-5-1") == (3, 5, 1)
    assert parse_raypath("") == ()
    try:
        parse_raypath("3--5")
    except ValueError:
        pass
    else:
        raise AssertionError("expected ValueError")


def test_env_knobs_registry():
    assert "IHT_GEOM_CLOCK" in env_knobs.KNOBS
    old = os.environ.get("IHT_GEOM_CLOCK")
    try:
        os.environ["IHT_GEOM_CLOCK"] = "128"  # above hi -> clamped to 64
        assert env_knobs.get("IHT_GEOM_CLOCK", 32) == 64
        os.environ["IHT_GEOM_CLOCK"] = "junk"
        assert env_knobs.get("IHT_GEOM_CLOCK", 32) == 32
        del os.environ["IHT_GEOM_CLOCK"]
        assert env_knobs.get("IHT_GEOM_CLOCK", 32) == 32
    finally:
        if old is not None:
            os.environ["IHT_GEOM_CLOCK"] = old
    assert "IHT_GEOM_CLOCK" in env_knobs.describe()

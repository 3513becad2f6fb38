"""Filter tests: canonicalization algebra, vectorized parity, e2e selection.

Oracles: hand-derived P/B/D folds (doc/raypath-symmetry.md semantics), the
scalar-vs-vectorized equivalence, and the physical check that a raypath
filter [3,5] with P symmetry isolates the 22-degree halo.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ice_halo_sim_jax.config.schema import (
    AxisDistribution,
    DirectionFilter,
    DistType,
    Distribution,
    EntryExitFilter,
    FilterAction,
    FilterConfig,
    NoneFilter,
    RaypathFilter,
    Symmetry,
)
from ice_halo_sim_jax.core import filters


def test_p_shift_canonicalization():
    # P symmetry: rotate prism faces so the first side face becomes 3.
    assert filters.reduce_raypath([4, 6], Symmetry.P) == [3, 5]
    assert filters.reduce_raypath([8, 4], Symmetry.P) == [3, 5]
    assert filters.reduce_raypath([3, 5], Symmetry.P) == [3, 5]
    # Basal faces pass through; first PRI anchors the shift.
    assert filters.reduce_raypath([1, 5, 7], Symmetry.P) == [1, 3, 5]
    # Pyramid faces keep their decade, pri rotates.
    assert filters.reduce_raypath([14, 16], Symmetry.P) == [13, 15]


def test_b_mirror():
    # B symmetry: basal 1<->2; pyramid upper<->lower; keep lex-smaller.
    assert filters.reduce_raypath([2, 3, 1], Symmetry.B) == [1, 3, 2]
    assert filters.reduce_raypath([1, 3, 2], Symmetry.B) == [1, 3, 2]
    # Pyramid: 13 <-> 23.
    assert filters.reduce_raypath([23, 5], Symmetry.B) == [13, 5]
    # No B-relevant faces: unchanged.
    assert filters.reduce_raypath([3, 5], Symmetry.B) == [3, 5]


def test_d_mirror():
    # D symmetry with sigma_a=0: pri0 -> (0 - pri0) mod 6.
    # [3,4] (pri0 0,1) -> mirror (0,5) = [3,8] -> P-shift [3,8]... with P:
    out = filters.reduce_raypath([3, 4], Symmetry.P | Symmetry.D, sigma_a=0, d_applicable=True)
    # mirror of [3,4] is [3,8]; P-canonical both start at 3; [3,4] < [3,8].
    assert out == [3, 4]
    # An asymmetric path where the mirror wins lexicographically.
    out2 = filters.reduce_raypath([3, 8], Symmetry.P | Symmetry.D, sigma_a=0, d_applicable=True)
    assert out2 == [3, 4]  # mirror of [3,8] is [3,4]


def test_d_applicability():
    full_az = Distribution(DistType.UNIFORM, 0.0, 360.0)
    axis = AxisDistribution(azimuth=full_az, latitude=Distribution(DistType.GAUSS, 90, 1),
                            roll=Distribution(DistType.UNIFORM, 0.0, 360.0))
    # Roll uniform-360 has mean 0 -> multiple of 30 -> applicable.
    assert filters.is_d_applicable(axis)
    axis2 = AxisDistribution(azimuth=full_az, latitude=axis.latitude,
                             roll=Distribution(DistType.NO_RANDOM, 17.0, 0.0))
    assert not filters.is_d_applicable(axis2)
    assert filters.compute_sigma_a(0.0) == 0
    assert filters.compute_sigma_a(30.0) == 5
    assert filters.compute_sigma_a(-30.0) == 1
    assert filters.compute_sigma_a(180.0) == 0


def test_vectorized_matches_scalar():
    rs = np.random.default_rng(3)
    n, L = 500, 7
    lens = rs.integers(1, L + 1, n)
    paths = np.zeros((n, L), np.int32)
    pool = [1, 2, 3, 4, 5, 6, 7, 8, 13, 15, 18, 23, 26]
    for i in range(n):
        paths[i, : lens[i]] = rs.choice(pool, lens[i])
    for sym in [Symmetry.P, Symmetry.B, Symmetry.P | Symmetry.B,
                Symmetry.P | Symmetry.B | Symmetry.D]:
        for sigma_a in (0, 2):
            vec = np.asarray(
                filters.reduce_paths(jnp.asarray(paths), jnp.asarray(lens), sym, sigma_a, True)
            )
            for i in range(0, n, 17):
                ref = filters.reduce_raypath(paths[i, : lens[i]], sym, sigma_a, True)
                np.testing.assert_array_equal(vec[i, : lens[i]], ref, err_msg=f"{sym} {i}")


def _check(plan, paths, lens, dirs=None):
    n = len(lens)
    d = dirs if dirs is not None else np.zeros((n, 3), np.float32)
    return np.asarray(
        filters.check_exits(plan, jnp.asarray(paths, jnp.int32), jnp.asarray(lens, jnp.int32),
                            jnp.asarray(d, jnp.float32))
    )


def _plan(param, symmetry=Symmetry.NONE, action=FilterAction.FILTER_IN, axis=None):
    axis = axis or AxisDistribution(
        azimuth=Distribution(DistType.UNIFORM, 0.0, 360.0),
        latitude=Distribution(DistType.GAUSS, 90, 1),
        roll=Distribution(DistType.UNIFORM, 0.0, 360.0),
    )
    cfg = FilterConfig(id=1, param=param, symmetry=symmetry, action=action)
    return filters.build_filter_plan(cfg, axis, {}, setting_crystal_id=1)


def test_raypath_filter_check():
    plan = _plan(RaypathFilter(raypath=(3, 5)), symmetry=Symmetry.P)
    paths = np.array([[3, 5, 0], [4, 6, 0], [3, 6, 0], [3, 5, 7]], np.int32)
    lens = np.array([2, 2, 2, 3], np.int32)
    got = _check(plan, paths, lens)
    # [4,6] folds to [3,5] under P; [3,6] folds to [3,6]; length-3 fails.
    np.testing.assert_array_equal(got, [True, True, False, False])


def test_filter_out_action():
    plan = _plan(RaypathFilter(raypath=(3, 5)), symmetry=Symmetry.P,
                 action=FilterAction.FILTER_OUT)
    paths = np.array([[3, 5], [3, 6]], np.int32)
    got = _check(plan, paths, np.array([2, 2], np.int32))
    np.testing.assert_array_equal(got, [False, True])


def test_entry_exit_filter():
    plan = _plan(EntryExitFilter(entry=3, exit=5), symmetry=Symmetry.NONE)
    paths = np.array([[3, 7, 5], [3, 5, 0], [5, 7, 3], [3, 7, 6]], np.int32)
    lens = np.array([3, 2, 3, 3], np.int32)
    got = _check(plan, paths, lens)
    np.testing.assert_array_equal(got, [True, True, False, False])
    # Wildcard exit.
    plan2 = _plan(EntryExitFilter(entry=1, exit=None))
    paths2 = np.array([[1, 4, 2], [2, 4, 1]], np.int32)
    got2 = _check(plan2, paths2, np.array([3, 3], np.int32))
    np.testing.assert_array_equal(got2, [True, False])
    # min_len gate.
    plan3 = _plan(EntryExitFilter(entry=None, exit=None, min_len=3))
    got3 = _check(plan3, paths2, np.array([2, 3], np.int32))
    np.testing.assert_array_equal(got3, [False, True])


def test_direction_filter():
    plan = _plan(DirectionFilter(az=0.0, el=90.0, radii=10.0))
    dirs = np.array(
        [[0, 0, 1.0], [0, np.sin(np.deg2rad(5)), np.cos(np.deg2rad(5))],
         [0, np.sin(np.deg2rad(15)), np.cos(np.deg2rad(15))], [0, 0, -1.0]],
        np.float32,
    )
    paths = np.zeros((4, 2), np.int32)
    got = _check(plan, paths, np.ones(4, np.int32), dirs)
    np.testing.assert_array_equal(got, [True, True, False, False])


def test_complex_filter_or_of_and():
    from ice_halo_sim_jax.config.schema import ComplexFilter, CrystalFilter

    all_filters = {
        1: FilterConfig(id=1, param=RaypathFilter(raypath=(3, 5)), symmetry=Symmetry.P),
        2: FilterConfig(id=2, param=CrystalFilter(crystal_id=1)),
        3: FilterConfig(id=3, param=RaypathFilter(raypath=(1, 2))),
    }
    cfg = FilterConfig(id=9, param=ComplexFilter(composition=((1, 2), (3,))))
    axis = AxisDistribution()
    plan = filters.build_filter_plan(cfg, axis, all_filters, setting_crystal_id=1)
    paths = np.array([[3, 5], [1, 2], [3, 6]], np.int32)
    got = _check(plan, paths, np.array([2, 2, 2], np.int32))
    np.testing.assert_array_equal(got, [True, True, False])
    # Same complex on a setting whose crystal is NOT id 1: clause 1 dies.
    plan2 = filters.build_filter_plan(cfg, axis, all_filters, setting_crystal_id=2)
    got2 = _check(plan2, paths, np.array([2, 2, 2], np.int32))
    np.testing.assert_array_equal(got2, [False, True, False])


def test_engine_raypath_filter_isolates_22_halo():
    """End-to-end: filtering to P-folded path [3,5] keeps ONLY the 60-degree
    prism transits — all landed radiance sits in the 22-degree annulus."""
    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine

    cfg_doc = {
        "crystal": [
            {"id": 1, "type": "prism", "shape": {"height": 1.0},
             "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360},
                      "azimuth": {"type": "uniform", "mean": 0, "std": 360},
                      "roll": {"type": "uniform", "mean": 0, "std": 360}}}
        ],
        "filter": [
            {"id": 1, "type": "raypath", "raypath": [3, 5], "symmetry": "P"}
        ],
        "scene": {
            "light_source": {"type": "sun", "altitude": 90, "azimuth": 0, "diameter": 0.5,
                             "spectrum": [{"wavelength": 550, "weight": 1.0}]},
            "ray_num": 100000, "max_hits": 6,
            "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "filter": 1,
                                                      "proportion": 100}]}],
        },
        "render": [
            {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 120},
             "resolution": [128, 128], "view": {"elevation": 90}, "visible": "full"}
        ],
    }
    e = Engine(load_project(cfg_doc), seed=11, batch_size=1 << 15)
    e.run(n_batches=4)
    xyz = e.raw_xyz(0)
    y = xyz[..., 1]
    h, w = y.shape
    yy, xx = np.mgrid[0:h, 0:w]
    scale = e.proj_plans[0].scale
    theta = np.degrees(
        2 * np.arcsin(np.clip(np.hypot(xx - w / 2, yy - h / 2) / (scale * np.sqrt(2)), 0, 1))
    )
    total = y.sum()
    assert total > 0
    ring = y[(theta > 21) & (theta < 45)].sum()
    # Everything lands in the deviation band of the 60-degree prism transit
    # (min deviation ~21.8 deg up to the grazing-incidence max ~43.5 deg).
    assert ring / total > 0.98
    # The forward direction (straight-through + external reflection) is gone.
    assert y[theta < 5].sum() / total < 1e-3


def test_prefix_soa_matches_slots_path():
    """The slot-major production filter path (check_exits_prefix_soa) must
    agree with the AoS reference formulation for every slot, symmetry, and
    filter kind, including dead slots and FILTER_OUT."""
    import numpy as np
    from ice_halo_sim_jax.config.schema import (
        AxisDistribution, ComplexFilter, DirectionFilter, Distribution,
        DistType, EntryExitFilter, FilterAction, FilterConfig, RaypathFilter,
        Symmetry,
    )

    rng = np.random.default_rng(42)
    H, B = 6, 512
    path = rng.choice([1, 2, 3, 4, 5, 6, 7, 8], size=(H, B)).astype(np.int32)
    live = rng.random((H, B)) < 0.7
    d = rng.normal(size=(3, H, B)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)

    axis = AxisDistribution(
        latitude=Distribution(DistType.GAUSS, 0.0, 2.0),
        azimuth=Distribution(DistType.UNIFORM, 0.0, 360.0),
        roll=Distribution(DistType.UNIFORM, 0.0, 360.0),
    )
    sub_fcs = {
        10: FilterConfig(id=10, param=RaypathFilter(raypath=(3, 5)),
                         symmetry=Symmetry.P | Symmetry.B, action=FilterAction.FILTER_IN),
        11: FilterConfig(id=11, param=DirectionFilter(az=30.0, el=10.0, radii=60.0),
                         symmetry=Symmetry.NONE, action=FilterAction.FILTER_IN),
        12: FilterConfig(id=12, param=EntryExitFilter(entry=3, exit=6, min_len=2, max_len=5),
                         symmetry=Symmetry.P, action=FilterAction.FILTER_IN),
        13: FilterConfig(id=13, param=RaypathFilter(raypath=(1, 3, 2)),
                         symmetry=Symmetry.P | Symmetry.B | Symmetry.D,
                         action=FilterAction.FILTER_IN),
    }
    cases = [
        FilterConfig(id=1, param=RaypathFilter(raypath=(3, 5)),
                     symmetry=Symmetry.P | Symmetry.B, action=FilterAction.FILTER_IN),
        FilterConfig(id=2, param=RaypathFilter(raypath=(1, 3, 2)),
                     symmetry=Symmetry.P | Symmetry.B | Symmetry.D,
                     action=FilterAction.FILTER_OUT),
        FilterConfig(id=3, param=EntryExitFilter(entry=3, exit=6, min_len=2, max_len=5),
                     symmetry=Symmetry.P, action=FilterAction.FILTER_IN),
        FilterConfig(id=4, param=DirectionFilter(az=30.0, el=10.0, radii=60.0),
                     symmetry=Symmetry.NONE, action=FilterAction.FILTER_OUT),
        FilterConfig(id=5, param=ComplexFilter(composition=((10, 11), (12,), (13,))),
                     symmetry=Symmetry.NONE, action=FilterAction.FILTER_IN),
    ]
    slot_len = np.arange(1, H + 1, dtype=np.int32)[:, None]
    lens_aos = np.where(live, slot_len, 0).T.astype(np.int32)     # [B, H]
    path_aos = np.broadcast_to(path.T[:, None, :], (B, H, H)).reshape(B * H, H)
    dirs_aos = np.moveaxis(d, 0, -1).transpose(1, 0, 2).reshape(B * H, 3)

    for fc in cases:
        plan = filters.build_filter_plan(fc, axis, sub_fcs, 1)
        got = np.asarray(filters.check_exits_prefix_soa(
            plan, jnp.asarray(path), jnp.asarray(live),
            (jnp.asarray(d[0]), jnp.asarray(d[1]), jnp.asarray(d[2])),
        ))
        want = np.asarray(filters.check_exits(
            plan, jnp.asarray(path_aos), jnp.asarray(lens_aos.reshape(-1)),
            jnp.asarray(dirs_aos),
        )).reshape(B, H).T
        # Dead slots carry zero weight; parity is required on LIVE slots.
        np.testing.assert_array_equal(got[live], want[live], err_msg=str(fc.id))

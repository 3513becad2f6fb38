"""Shape-scalar sync groups: slots sharing one RNG draw per crystal instance.

Reference semantics: crystal_config.hpp:184-198 (shared draw), :81-88
(canonicalize so equal partitions compare equal), crystal_config.cpp:100-128
(leader-normalize with warning).
"""

import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.loader import load_project, parse_crystal
from ice_halo_sim_jax.config.schema import (
    DistType,
    Distribution,
    canonicalize_sync_groups,
    prepare_sync_groups,
    sync_group_leaders,
)
from ice_halo_sim_jax.config.serialize import crystal_to_json, project_to_dict
from ice_halo_sim_jax.core import rng
from ice_halo_sim_jax.engine.simulator import Engine, _sample_shape_scalars


def _scene(crystal):
    return {
        "crystal": [crystal],
        "filter": [],
        "scene": {
            "light_source": {
                "type": "sun", "altitude": 20.0,
                "spectrum": [{"wavelength": 550.0, "weight": 1.0}],
            },
            "ray_num": 1000,
            "max_hits": 4,
            "scattering": [
                {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 100.0}]}
            ],
        },
        "render": [
            {"id": 1, "lens": {"type": "linear", "fov": 80.0},
             "resolution": [64, 32], "view": {"elevation": 30.0},
             "visible": "full"},
        ],
    }


GAUSS_H = {"type": "gauss", "mean": 1.0, "std": 0.3}


def test_canonicalize_singletons_and_renumber():
    # Singleton groups ARE independence; survivors renumber by appearance.
    assert canonicalize_sync_groups((5, 0, 0, 0, 0, 0, 0)) == (0,) * 7
    assert canonicalize_sync_groups((2, 1, 2, 1, 2, 1, 0)) == (1, 2, 1, 2, 1, 2, 0)
    assert canonicalize_sync_groups((9, 9, 0, 3, 3, 0, 0)) == (1, 1, 0, 2, 2, 0, 0)


def test_equal_partitions_compare_equal():
    # [2,1,2,1,2,1] and [1,2,1,2,1,2] are the same partition; the
    # re-simulation trigger (config value equality) must see them as equal.
    def crystal(groups):
        return parse_crystal({
            "id": 1, "type": "prism",
            "shape": {
                "height": GAUSS_H,
                "sync_group": {
                    "height": groups[0],
                    "face_distance": list(groups[1:]),
                },
            },
        })

    a = crystal([2, 1, 2, 1, 2, 1])
    b = crystal([1, 2, 1, 2, 1, 2])
    assert a == b
    assert a.shape.sync_group == (1, 2, 1, 2, 1, 2, 0)


def test_leader_normalize_overwrites_member_distribution():
    shape = parse_crystal({
        "id": 1, "type": "prism",
        "shape": {
            "height": GAUSS_H,
            "face_distance": [
                {"type": "uniform", "mean": 1.0, "std": 0.4},
                1.0, 1.0, 1.0, 1.0, 1.0,
            ],
            "sync_group": {"height": 1, "face_distance": [1, 0, 0, 0, 0, 0]},
        },
    }).shape
    # fd0 declared uniform but is in height's group: leader (height) wins.
    assert shape.face_distance[0] == shape.height
    assert shape.height == Distribution(DistType.GAUSS, 1.0, 0.3)


def test_sync_group_leaders():
    assert sync_group_leaders((0, 0, 0)) == (0, 1, 2)
    assert sync_group_leaders((1, 0, 1)) == (0, 1, 0)
    assert sync_group_leaders((0, 2, 2)) == (0, 1, 1)


def test_synced_prism_shares_one_raw_draw():
    cfg = load_project(_scene({
        "id": 1, "type": "prism",
        "shape": {
            "height": GAUSS_H,
            "sync_group": {"height": 1, "face_distance": [1, 0, 0, 0, 0, 0]},
        },
    }))
    eng = Engine(cfg, seed=3, batch_size=256)
    sp = eng.layers[0].shape_param_arrays[0]
    assert sp["h_slot"] == sp["d_slots"][0] == 0
    assert sp["d_slots"][1:] == [4, 6, 8, 10, 12]
    seed = jnp.uint32(eng.seed) ^ rng.NONCE_GEOM_SHAPE ^ jnp.uint32(0)
    k_idx = jnp.arange(8, dtype=jnp.uint32)
    h_raw = _sample_shape_scalars(seed, k_idx, sp["h_slot"], sp["h"])
    d0_raw = _sample_shape_scalars(seed, k_idx, sp["d_slots"][0], sp["d"][0])
    # One shared RAW draw: the height consumes |v|, the face distance v.
    np.testing.assert_array_equal(np.asarray(h_raw), np.asarray(d0_raw))
    assert np.asarray(h_raw).std() > 0  # the draw is actually random


def test_unsynced_prism_draws_independently():
    cfg = load_project(_scene({
        "id": 1, "type": "prism",
        "shape": {
            "height": GAUSS_H,
            "face_distance": [GAUSS_H, 1.0, 1.0, 1.0, 1.0, 1.0],
        },
    }))
    eng = Engine(cfg, seed=3, batch_size=256)
    sp = eng.layers[0].shape_param_arrays[0]
    seed = jnp.uint32(eng.seed) ^ rng.NONCE_GEOM_SHAPE ^ jnp.uint32(0)
    k_idx = jnp.arange(8, dtype=jnp.uint32)
    h_raw = _sample_shape_scalars(seed, k_idx, sp["h_slot"], sp["h"])
    d0_raw = _sample_shape_scalars(seed, k_idx, sp["d_slots"][0], sp["d"][0])
    assert not np.array_equal(np.asarray(h_raw), np.asarray(d0_raw))


def test_pyramid_sync_groups_parse_and_slots():
    cfg = load_project(_scene({
        "id": 1, "type": "pyramid",
        "shape": {
            "prism_h": GAUSS_H,
            "upper_h": {"type": "gauss", "mean": 0.3, "std": 0.1},
            "lower_h": 0.2,
            "sync_group": {"upper_h": 7, "prism_h": 7},
        },
    }))
    shape = cfg.crystals[1].shape
    assert shape.sync_group == (1, 1, 0, 0, 0, 0, 0, 0, 0)
    # Leader = upper_h (lowest slot); prism_h's dist was overwritten.
    assert shape.prism_h == shape.upper_h
    eng = Engine(cfg, seed=3, batch_size=256)
    sp = eng.layers[0].shape_param_arrays[0]
    assert sp["u_slot"] == sp["p_slot"] == 0
    assert sp["l_slot"] == 4


def test_sync_group_serialize_round_trip():
    crystal = parse_crystal({
        "id": 1, "type": "prism",
        "shape": {
            "height": GAUSS_H,
            "sync_group": {"height": 1, "face_distance": [1, 1, 0, 0, 0, 0]},
        },
    })
    j = crystal_to_json(crystal)
    assert j["shape"]["sync_group"] == {
        "height": 1, "face_distance": [1, 1, 0, 0, 0, 0]}
    assert parse_crystal(j) == crystal


def test_no_sync_group_serializes_nothing():
    crystal = parse_crystal({
        "id": 1, "type": "prism", "shape": {"height": GAUSS_H},
    })
    assert "sync_group" not in crystal_to_json(crystal)["shape"]


def test_commit_reuse_of_equal_partitions():
    from ice_halo_sim_jax.engine.server import Server

    def scene(groups):
        return _scene({
            "id": 1, "type": "prism",
            "shape": {
                "height": GAUSS_H,
                "sync_group": {
                    "height": groups[0], "face_distance": list(groups[1:])},
            },
        })

    srv = Server(seed=5, batch_size=256)
    try:
        assert srv.commit(scene([2, 1, 2, 1, 2, 1])) is False  # fresh
        # Same partition, different numbering: must REUSE, not re-simulate.
        assert srv.commit(scene([1, 2, 1, 2, 1, 2])) is True
    finally:
        srv.stop()


def test_prepare_is_idempotent():
    shape = parse_crystal({
        "id": 1, "type": "prism",
        "shape": {
            "height": GAUSS_H,
            "sync_group": {"height": 3, "face_distance": [0, 3, 0, 9, 0, 0]},
        },
    }).shape
    again, warnings = prepare_sync_groups(shape)
    assert again == shape and not warnings

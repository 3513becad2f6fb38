"""Serialization, checkpoint/resume, and mesh-export tests."""

import glob

import numpy as np
import pytest

from ice_halo_sim_jax.config.loader import load_project, load_project_file
from ice_halo_sim_jax.config.serialize import project_to_dict, project_to_json
from ice_halo_sim_jax.core.mesh import (
    crystal_mesh,
    geom_to_mesh,
    is_closed_tri_mesh,
    mesh_to_obj,
)
from ice_halo_sim_jax.engine.checkpoint import load_checkpoint, save_checkpoint
from ice_halo_sim_jax.engine.simulator import Engine

CFG = {
    "crystal": [
        {
            "id": 1,
            "type": "prism",
            "shape": {"height": 1.0},
            "axis": {
                "zenith": {"type": "uniform", "mean": 90, "std": 360},
                "azimuth": {"type": "uniform", "mean": 0, "std": 360},
            },
        }
    ],
    "filter": [],
    "scene": {
        "light_source": {
            "type": "sun",
            "altitude": 25,
            "spectrum": [{"wavelength": 550, "weight": 1.0}],
        },
        "ray_num": 32768,
        "max_hits": 6,
        "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 1}]}],
    },
    "render": [
        {
            "id": 1,
            "lens": {"type": "fisheye_equal_area", "fov": 120},
            "resolution": [64, 64],
            "view": {"elevation": 25},
        }
    ],
}


def test_serialize_roundtrip_all_reference_configs():
    """load(serialize(load(x))) == load(x) over the whole reference corpus."""
    paths = sorted(glob.glob("/root/reference/test/e2e/configs/*.json"))
    paths.append("/root/reference/examples/config_example.json")
    checked = 0
    for p in paths:
        cfg = load_project_file(p)
        assert load_project(project_to_dict(cfg)) == cfg, f"roundtrip mismatch: {p}"
        checked += 1
    assert checked >= 60
    # JSON text form parses too.
    import json

    cfg = load_project_file(paths[-1])
    assert load_project(json.loads(project_to_json(cfg))) == cfg


def test_checkpoint_resume_bit_exact(tmp_path):
    """Save mid-run, resume, finish: identical accumulators to an
    uninterrupted run (same seed, same batch counter stream)."""
    cfg = load_project(CFG)
    path = str(tmp_path / "ckpt.npz")

    a = Engine(cfg, seed=11, batch_size=1 << 14)
    a.run(n_batches=2)
    save_checkpoint(path, a)
    a.run(n_batches=2)

    b = load_checkpoint(path)
    assert b.batch_counter == 2
    assert b.stats.rays_traced == 2 * b.batch_size
    b.run(n_batches=2)

    for x, y in zip(a.accum, b.accum):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a.stats == b.stats


def test_checkpoint_rejects_wrong_shape(tmp_path):
    cfg = load_project(CFG)
    eng = Engine(cfg, seed=1, batch_size=1 << 14)
    eng.run(n_batches=1)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, eng)
    # Corrupt: change resolution in stored project json.
    import json

    data = dict(np.load(path, allow_pickle=False))
    header = json.loads(str(data["header"]))
    header["project"]["render"][0]["resolution"] = [32, 32]
    data["header"] = json.dumps(header)
    np.savez_compressed(path, **data)
    with pytest.raises(ValueError):
        load_checkpoint(path)


def test_prism_mesh_is_closed():
    cfg = load_project(CFG)
    mesh = crystal_mesh(cfg.crystals[1].shape)
    # Hexagonal prism: 12 vertices, 2x4 + 6x2 = 20 triangles.
    assert mesh.vertices.shape == (12, 3)
    assert mesh.triangles.shape[0] == 20
    assert is_closed_tri_mesh(len(mesh.vertices), len(mesh.triangles))
    # Face numbers present: basal 1-2 and laterals 3-8.
    assert set(mesh.face_numbers.tolist()) == {1, 2, 3, 4, 5, 6, 7, 8}
    obj = mesh_to_obj(mesh)
    assert obj.count("\nv ") == 12
    assert obj.count("\nf ") == 20


def test_pyramid_mesh_closed():
    doc = {
        **CFG,
        "crystal": [
            {
                "id": 1,
                "type": "pyramid",
                "shape": {
                    "upper_h": 0.5,
                    "prism_h": 0.4,
                    "lower_h": 0.5,
                    "upper_indices": [1, 0, 1],
                },
                "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360}},
            }
        ],
    }
    cfg = load_project(doc)
    mesh = crystal_mesh(cfg.crystals[1].shape)
    assert len(mesh.triangles) > 20  # pyramid caps add faces
    assert is_closed_tri_mesh(len(mesh.vertices), len(mesh.triangles))
    assert (mesh.face_numbers >= 1).all()

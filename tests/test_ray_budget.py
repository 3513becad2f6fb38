"""Exact ray budgets: Engine.run(total_rays) traces exactly the request.

Reference semantics: the ray budget is sliced exactly across batches
(server.cpp:1477-1495) — a non-multiple-of-batch request must not round up
in either the traced work or the stats.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.loader import load_project
from ice_halo_sim_jax.engine.simulator import Engine

CFG = {
    "crystal": [
        {"id": 1, "type": "prism",
         "shape": {"height": 1.3},
         "axis": {
             "zenith": {"type": "gauss", "mean": 90.0, "std": 1.5},
             "azimuth": {"type": "uniform", "mean": 0.0, "std": 360.0},
         }},
    ],
    "filter": [],
    "scene": {
        "light_source": {
            "type": "sun", "altitude": 25.0,
            "spectrum": [{"wavelength": 550.0, "weight": 1.0}],
        },
        "ray_num": 3000,
        "max_hits": 4,
        "scattering": [
            {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 100.0}]}
        ],
    },
    "render": [
        {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 150.0},
         "resolution": [64, 32], "view": {"elevation": 25.0},
         "visible": "full"},
    ],
}


def test_stats_count_exact_request():
    eng = Engine(load_project(CFG), seed=5, batch_size=1024)
    stats = eng.run(total_rays=1536)
    assert stats.rays_traced == 1536
    stats = eng.run(total_rays=100)
    assert stats.rays_traced == 1536 + 100
    # Explicit batch count stays batch-granular.
    stats = eng.run(n_batches=2)
    assert stats.rays_traced == 1536 + 100 + 2 * eng.batch_size


def test_tail_batch_masks_exactly_the_last_lanes():
    eng = Engine(load_project(CFG), seed=5, batch_size=1024)
    B = eng.batch_size
    full = jax.jit(lambda bb, bc: eng._trace_batch_impl(bb, bc))(
        jnp.uint32(0), jnp.uint32(0))
    part = jax.jit(
        lambda bb, bc: eng._trace_batch_impl(bb, bc, jnp.uint32(512))
    )(jnp.uint32(0), jnp.uint32(0))
    (pix_f, w_f, _, _) = full[0][0]
    (pix_p, w_p, _, _) = part[0][0]
    lane = np.arange(pix_f.shape[0]) % B
    live_lane = lane < 512
    # Active lanes are bit-identical to the full batch; inactive lanes
    # contribute zero weight.
    np.testing.assert_array_equal(
        np.asarray(w_p)[live_lane], np.asarray(w_f)[live_lane])
    np.testing.assert_array_equal(np.asarray(w_p)[~live_lane], 0.0)
    np.testing.assert_array_equal(
        np.asarray(pix_p)[live_lane], np.asarray(pix_f)[live_lane])
    # Segment count only counts live lanes.
    assert int(part[3]) < int(full[3])


def test_budget_image_equals_full_batches_plus_masked_tail():
    eng_a = Engine(load_project(CFG), seed=7, batch_size=1024)
    eng_a.run(total_rays=1536)
    img_a = eng_a.raw_xyz(0)

    eng_b = Engine(load_project(CFG), seed=7, batch_size=1024)
    acc = eng_b.accum
    acc = eng_b._step(acc, jnp.uint32(0), jnp.uint32(0), None, 0, None)[0]
    base1 = eng_b.batch_size * max(1, len(eng_b.layers) + 1)
    acc = eng_b._step(acc, jnp.uint32(base1), jnp.uint32(1), None, 0,
                      jnp.uint32(512))[0]
    p = eng_b.proj_plans[0]
    img_b = np.asarray(acc[0][:, :3]).reshape(p.height, p.width, 3)
    np.testing.assert_allclose(img_a, img_b, rtol=1e-6, atol=1e-7)
    assert img_a.sum() > 0

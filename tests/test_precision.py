"""Matmul precision on the main path.

A float32 matmul without a precision may run in TF32 on a GPU's tensor
cores (10 mantissa bits), which would shift or blur halo features without
any CPU test noticing. Every dot_general in the engine's step, and in the
geometry helpers the step and the tools use, must name HIGHEST; table reads
are gathers and the SoA trace is componentwise. The jaxpr is inspected
here, on the CPU; chip_smoke.py repeats the check on the card.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from bench import BENCH_CFG
from ice_halo_sim_jax.config.loader import load_project
from ice_halo_sim_jax.engine.simulator import Engine

_RENDER = [{"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 120},
            "resolution": [64, 64], "view": {"elevation": 90}, "visible": "full"}]
_PRISM = {"id": 1, "type": "prism", "shape": {"height": 1.0},
          "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360},
                   "azimuth": {"type": "uniform", "mean": 0, "std": 360},
                   "roll": {"type": "uniform", "mean": 0, "std": 360}}}
_SUN = {"type": "sun", "altitude": 30, "azimuth": 0, "diameter": 0.5,
        "spectrum": [{"wavelength": 550, "weight": 1.0}]}


def _scene(name):
    if name == "light":
        doc = copy.deepcopy(BENCH_CFG)
        doc["render"][0]["resolution"] = [64, 32]
        return doc
    if name == "pyramid":
        return copy.deepcopy(chip_smoke.PYRAMID_CFG)
    doc = {"crystal": [copy.deepcopy(_PRISM)], "filter": [],
           "scene": {"light_source": _SUN, "ray_num": 10000, "max_hits": 5,
                     "scattering": [{"prob": 0.0, "entries": [
                         {"crystal": 1, "proportion": 100}]}]},
           "render": copy.deepcopy(_RENDER)}
    if name == "multi_layer":
        doc["crystal"].append({"id": 2, "type": "prism", "shape": {"height": 0.3},
                               "axis": {"zenith": {"type": "gauss", "mean": 0, "std": 1}}})
        doc["scene"]["scattering"] = [
            {"prob": 0.5, "entries": [{"crystal": 1, "proportion": 50},
                                      {"crystal": 2, "proportion": 50}]},
            {"prob": 0.0, "entries": [{"crystal": 2, "proportion": 100}]},
        ]
    elif name == "filtered":
        doc["filter"] = [{"id": 1, "type": "raypath", "raypath": [3, 5],
                          "symmetry": "P"}]
        doc["scene"]["scattering"][0]["entries"][0]["filter"] = 1
    elif name == "raypath_color":
        doc["raypath_color"] = [
            {"color": [1, 0, 0], "match": [{"layer": 0, "crystal": 1,
                                            "raypath": [3, 5], "symmetry": "P"}]},
            {"color": [0, 0, 1], "match": [{"layer": 0, "crystal": 1}]},
        ]
    return doc


@pytest.mark.parametrize(
    "name", ["light", "multi_layer", "filtered", "pyramid", "raypath_color"]
)
def test_step_matmuls_are_highest(name):
    eng = Engine(load_project(_scene(name)), seed=1, batch_size=1 << 12)
    report = chip_smoke.step_matmuls(eng)
    chip_smoke.assert_highest(report)


def _dot_precisions(fn, *args):
    closed = jax.make_jaxpr(fn)(*args)
    return [str(e.params.get("precision"))
            for e in chip_smoke._walk_eqns(closed.jaxpr)
            if e.primitive.name == "dot_general"]


def _geometry_fns():
    from ice_halo_sim_jax.core import projection, sampling, trace

    rot = jnp.eye(3)[None].repeat(4, axis=0)
    v = jnp.ones((4, 3)) / np.sqrt(3.0)
    plan = projection.make_proj_plan(load_project(_scene("filtered")).renders[0])
    globe_cfg = _scene("filtered")
    globe_cfg["render"][0]["lens"] = {"type": "globe", "fov": 80}
    globe_plan = projection.make_proj_plan(load_project(globe_cfg).renders[0])

    eng = Engine(load_project(_scene("filtered")), seed=1, batch_size=1 << 10)
    pool = jax.jit(lambda: eng._sample_layer_pool(0, eng.layers[0], jnp.uint32(0)))()
    shared = jax.tree.map(lambda a: a[:1], pool)
    n = 8

    def aos_trace(d):
        return trace.trace_layer(
            3, jnp.arange(n, dtype=jnp.uint32), d, jnp.ones(n),
            jnp.eye(3)[None].repeat(n, axis=0), None, shared,
            jnp.full(n, 1.31), 4,
        ).w

    px = jnp.arange(4, dtype=jnp.float32) + 10.0
    return {
        "rotate": (sampling.rotate, (rot, v)),
        "rotate_inv": (sampling.rotate_inv, (rot, v)),
        "project_continuous": (lambda d: projection.project_continuous(plan, d), (v,)),
        "unproject_fisheye": (lambda x, y: projection.unproject(plan, x, y), (px, px)),
        "unproject_globe": (lambda x, y: projection.unproject(globe_plan, x, y), (px, px)),
        "aos_trace_shared": (aos_trace, (jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1)),)),
    }


@pytest.mark.parametrize(
    "fn_name",
    ["rotate", "rotate_inv", "project_continuous", "unproject_fisheye",
     "unproject_globe", "aos_trace_shared"],
)
def test_geometry_matmuls_are_highest(fn_name):
    fn, args = _geometry_fns()[fn_name]
    precisions = _dot_precisions(fn, *args)
    assert precisions, f"{fn_name}: expected at least one matmul"
    assert all("HIGHEST" in p for p in precisions), precisions


def test_audit_sees_default_precision_inside_control_flow():
    """The walker descends into cond/jit bodies and reports a matmul that
    names no precision, so the checks above are not vacuous."""
    a = jnp.ones((4, 3))

    def fn(x):
        inner = jax.jit(lambda y: y @ a.T)
        return jax.lax.cond(x[0, 0] > 0, inner, lambda y: y @ a.T * 2.0, x)

    precisions = _dot_precisions(fn, a)
    assert len(precisions) == 2
    assert not any("HIGHEST" in p for p in precisions)
    with pytest.raises(AssertionError):
        chip_smoke.assert_highest({"dot_general": precisions, "pallas_calls": 0})

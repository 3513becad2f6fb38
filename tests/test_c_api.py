"""C API tests: build libiht, drive it standalone and in-process.

Covers both interpreter-ownership modes of the native layer
(native/src/c_api.cpp): the standalone C front-end (iht_smoke embeds
Python itself — the reference-CLI role) and ctypes loading into an already
running interpreter (the reference GUI/FFI role).
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "native", "build")

SCENE = {
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


@pytest.fixture(scope="module")
def native_build():
    if shutil.which("cmake") is None:
        pytest.skip("cmake not available")
    if not os.path.exists(os.path.join(BUILD, "build.ninja")):
        gen = ["-G", "Ninja"] if shutil.which("ninja") else []
        subprocess.run(
            ["cmake", "-S", os.path.join(REPO, "native"), "-B", BUILD, *gen],
            check=True, capture_output=True,
        )
    subprocess.run(
        ["cmake", "--build", BUILD], check=True, capture_output=True
    )
    return BUILD


@pytest.mark.slow
def test_standalone_c_frontend(native_build, tmp_path):
    """iht_smoke embeds Python itself and exercises the full C surface."""
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(SCENE))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [os.path.join(native_build, "iht_smoke"), str(scene)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, f"stderr: {res.stderr}\nstdout: {res.stdout}"
    assert "iht_smoke OK" in res.stdout


@pytest.fixture(scope="module")
def lib(native_build):
    lib = ctypes.CDLL(os.path.join(native_build, "libiht.so"))
    lib.IHT_ApiVersion.restype = ctypes.c_int
    lib.IHT_LastError.restype = ctypes.c_char_p
    lib.IHT_CreateServer.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint, ctypes.c_int,
    ]
    lib.IHT_CommitSceneJson.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
    ]
    lib.IHT_WaitIdle.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.IHT_GetSimRayCount.argtypes = [ctypes.c_void_p]
    lib.IHT_GetSimRayCount.restype = ctypes.c_longlong
    lib.IHT_AcquireResultFrame.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.IHT_FrameGetRenderSize.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.IHT_FrameGetRender.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.IHT_DestroyServer.argtypes = [ctypes.c_void_p]
    lib.IHT_ReleaseResultFrame.argtypes = [ctypes.c_void_p]
    lib.IHT_ValidateRaypathText.argtypes = [ctypes.c_char_p, ctypes.c_int]
    return lib


def test_inprocess_ctypes_roundtrip(lib):
    """libiht joins the running interpreter (GUI/FFI embedding mode)."""
    assert lib.IHT_ApiVersion() == 1
    server = ctypes.c_void_p()
    assert lib.IHT_CreateServer(ctypes.byref(server), 7, 16384) == 0, (
        lib.IHT_LastError()
    )
    reused = ctypes.c_int(-1)
    rc = lib.IHT_CommitSceneJson(
        server, json.dumps(SCENE).encode(), ctypes.byref(reused)
    )
    assert rc == 0, lib.IHT_LastError()
    assert reused.value == 0
    assert lib.IHT_WaitIdle(server, 300.0) == 0
    assert lib.IHT_GetSimRayCount(server) >= SCENE["scene"]["ray_num"]

    frame = ctypes.c_void_p()
    assert lib.IHT_AcquireResultFrame(server, ctypes.byref(frame)) == 0
    w, h = ctypes.c_int(), ctypes.c_int()
    assert lib.IHT_FrameGetRenderSize(frame, 0, ctypes.byref(w), ctypes.byref(h)) == 0
    assert (w.value, h.value) == (64, 64)
    buf = ctypes.create_string_buffer(w.value * h.value * 3)
    assert lib.IHT_FrameGetRender(frame, 0, buf, len(buf)) == 0
    assert any(b > 10 for b in buf.raw)
    assert lib.IHT_ReleaseResultFrame(frame) == 0
    assert lib.IHT_DestroyServer(server) == 0


def test_validation_helpers_no_python(lib):
    assert lib.IHT_ValidateRaypathText(b"3-5-1", -1) == 0
    assert lib.IHT_ValidateRaypathText(b"3-5-", -1) == 1
    assert lib.IHT_ValidateRaypathText(b"3--5", -1) == 2
    assert lib.IHT_ValidateRaypathText(b"3-13", 0) == 2   # prism: 13 illegal
    assert lib.IHT_ValidateRaypathText(b"3-13", 1) == 0   # pyramid: legal


COLOR_SCENE = dict(
    SCENE,
    raypath_color=[
        {"color": [1, 0, 0],
         "match": [{"layer": 0, "crystal": 1, "raypath": [3, 5],
                    "symmetry": "P"}]},
        {"color": [0, 1, 0], "match": [{"layer": 0, "crystal": 1}]},
    ],
)


@pytest.fixture(scope="module")
def lib2(lib):
    """Extended-surface prototypes (display-time color, lifecycle, mesh)."""
    lib.IHT_FrameHasComposite.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.IHT_FrameGetComposite.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
    ]
    lib.IHT_FrameGetLanded.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
    ]
    lib.IHT_FrameGetEvAuto.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
    ]
    lib.IHT_SetRaypathColors.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.IHT_SetCompositeExposure.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.IHT_GetColorClassSignal.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.IHT_GetColorOverflowInfo.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.IHT_GetDrainStatus.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.IHT_GetSimLifecycle.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.IHT_SetLogLevel.argtypes = [ctypes.c_char_p]
    lib.IHT_GetCrystalMesh.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.IHT_IsShapeScalarApplicable.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.IHT_ShapeScalarSyncKeyName.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.IHT_ShapeScalarSyncKeyName.restype = ctypes.c_char_p
    return lib


def test_display_time_color_control(lib2):
    """Composites, color-class signal, raypath-color updates, drain status,
    lifecycle — the display-time C surface (lumice.h:950-1091 analogs)."""
    lib = lib2
    server = ctypes.c_void_p()
    assert lib.IHT_CreateServer(ctypes.byref(server), 3, 16384) == 0
    rc = lib.IHT_CommitSceneJson(server, json.dumps(COLOR_SCENE).encode(), None)
    assert rc == 0, lib.IHT_LastError()
    assert lib.IHT_WaitIdle(server, 300.0) == 0

    cur, drained = ctypes.c_longlong(-1), ctypes.c_longlong(-1)
    assert lib.IHT_GetDrainStatus(server, ctypes.byref(cur), ctypes.byref(drained)) == 0
    assert cur.value == drained.value == 1

    state, epoch = ctypes.c_int(-1), ctypes.c_longlong(-1)
    assert lib.IHT_GetSimLifecycle(server, ctypes.byref(state), ctypes.byref(epoch)) == 0
    assert state.value == 0  # idle
    assert epoch.value == 1

    sig = (ctypes.c_int * 8)()
    n = lib.IHT_GetColorClassSignal(server, sig, 8)
    assert n == 2
    assert sig[1] == 1  # whole-crystal class always has signal

    oc, cap = ctypes.c_int(-1), ctypes.c_int(-1)
    assert lib.IHT_GetColorOverflowInfo(server, ctypes.byref(oc), ctypes.byref(cap)) == 0
    assert oc.value == 0 and cap.value > 0

    frame = ctypes.c_void_p()
    assert lib.IHT_AcquireResultFrame(server, ctypes.byref(frame)) == 0
    assert lib.IHT_FrameHasComposite(frame, 0) == 1
    w, h = ctypes.c_int(), ctypes.c_int()
    lib.IHT_FrameGetRenderSize(frame, 0, ctypes.byref(w), ctypes.byref(h))
    comp = (ctypes.c_float * (w.value * h.value * 3))()
    assert lib.IHT_FrameGetComposite(frame, 0, comp, len(comp)) == 0
    arr = list(comp)
    assert max(arr) > 0.0
    landed = ctypes.c_double(-1)
    assert lib.IHT_FrameGetLanded(frame, 0, ctypes.byref(landed)) == 0
    assert landed.value > 0
    ev = ctypes.c_double()
    assert lib.IHT_FrameGetEvAuto(frame, 0, ctypes.byref(ev)) == 0
    lib.IHT_ReleaseResultFrame(frame)

    # Display-time update: recolor class 0, hide class 1; no re-simulation
    # (generation must not change).
    upd = {"classes": [{"color": [0, 0, 1]},
                       {"color": [0, 1, 0], "visible": False}]}
    assert lib.IHT_SetRaypathColors(server, json.dumps(upd).encode()) == 0, (
        lib.IHT_LastError()
    )
    assert lib.IHT_SetCompositeExposure(server, 1.5) == 0
    frame2 = ctypes.c_void_p()
    assert lib.IHT_AcquireResultFrame(server, ctypes.byref(frame2)) == 0
    assert lib.IHT_FrameGetGeneration(frame2) == 1
    comp2 = (ctypes.c_float * (w.value * h.value * 3))()
    assert lib.IHT_FrameGetComposite(frame2, 0, comp2, len(comp2)) == 0
    # class-1 (green, covers everything) is hidden now: composite changed
    assert list(comp2) != arr
    lib.IHT_ReleaseResultFrame(frame2)

    # class count mismatch must fail all-or-nothing
    bad = {"classes": [{"color": [1, 0, 0]}]}
    assert lib.IHT_SetRaypathColors(server, json.dumps(bad).encode()) != 0

    assert lib.IHT_DestroyServer(server) == 0


def test_crystal_mesh_and_shape_scalars(lib2):
    lib = lib2
    nv, nt = ctypes.c_int(-1), ctypes.c_int(-1)
    cjson = json.dumps({"type": "prism", "shape": {"height": 1.0}}).encode()
    # count query (NULL buffers)
    assert lib.IHT_GetCrystalMesh(cjson, None, 0, ctypes.byref(nv),
                                  None, 0, ctypes.byref(nt)) == 0
    assert nv.value == 12
    assert nt.value == 20  # closed hexagonal prism: 2V - 4 triangles
    verts = (ctypes.c_float * (nv.value * 3))()
    tris = (ctypes.c_int * (nt.value * 3))()
    assert lib.IHT_GetCrystalMesh(cjson, verts, len(verts), ctypes.byref(nv),
                                  tris, len(tris), ctypes.byref(nt)) == 0
    assert max(verts) > 0 and 0 <= min(tris) and max(tris) < nv.value

    # pyramid mesh
    pjson = json.dumps({
        "type": "pyramid",
        "shape": {"upper_h": 0.5, "prism_h": 1.0, "lower_h": 0.0},
    }).encode()
    assert lib.IHT_GetCrystalMesh(pjson, None, 0, ctypes.byref(nv),
                                  None, 0, ctypes.byref(nt)) == 0
    assert nv.value >= 12 and nt.value >= 20

    # shape-scalar slot map (crystal_config.hpp:32-41)
    assert lib.IHT_IsShapeScalarApplicable(0, 0) == 1   # prism height
    assert lib.IHT_IsShapeScalarApplicable(0, 1) == 0   # prism upper_h: no
    assert lib.IHT_IsShapeScalarApplicable(1, 0) == 0   # pyramid height: no
    assert all(lib.IHT_IsShapeScalarApplicable(k, s) == 1
               for k in (0, 1) for s in range(4, 10))
    assert lib.IHT_ShapeScalarSyncKeyName(0, 0) == b"height"
    assert lib.IHT_ShapeScalarSyncKeyName(1, 2) == b"prism_h"
    assert lib.IHT_ShapeScalarSyncKeyName(0, 5) == b"face_distance"
    assert lib.IHT_ShapeScalarSyncKeyName(1, 0) is None


def test_log_level_and_callback(lib2):
    lib = lib2
    assert lib.IHT_SetLogLevel(b"debug") == 0
    assert lib.IHT_SetLogLevel(b"nonsense") != 0
    seen = []
    CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p,
                          ctypes.c_char_p, ctypes.c_void_p)

    def on_log(level, logger, msg, user):
        seen.append((level, msg))

    cb = CB(on_log)
    lib.IHT_SetLogCallback.argtypes = [CB, ctypes.c_void_p]
    assert lib.IHT_SetLogCallback(cb, None) == 0
    from ice_halo_sim_jax.utils.log import get_logger
    get_logger("test").warning("hello from C callback test")
    assert any(b"hello from C callback test" in m for _, m in seen)
    # uninstall: must not fire afterwards
    null_cb = ctypes.cast(None, CB)
    assert lib.IHT_SetLogCallback(null_cb, None) == 0
    n0 = len(seen)
    get_logger("test").warning("after uninstall")
    assert len(seen) == n0
    assert lib.IHT_SetLogLevel(b"warning") == 0

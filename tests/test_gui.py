"""Web GUI front-end: page, status, frame PNG, EV re-tone-map, commit."""

import json
import urllib.request

import pytest

from tests.test_e2e import SMOKE_CFG


@pytest.mark.slow
def test_gui_serves_frames_and_commits():
    from ice_halo_sim_jax.gui.app import serve

    cfg = dict(SMOKE_CFG)
    cfg["scene"] = dict(SMOKE_CFG["scene"], ray_num=20000)
    httpd, gui = serve(json.dumps(cfg), port=0, seed=3, batch_size=4096,
                       block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        gui.server.wait_idle(timeout=300)

        page = urllib.request.urlopen(base + "/").read()
        assert b"live view" in page

        status = json.loads(urllib.request.urlopen(base + "/status").read())
        assert status["ray_count"] >= 20000
        assert status["renders"] == 1
        assert status["is_idle"] is True

        png = urllib.request.urlopen(base + "/frame/0.png").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        png_ev = urllib.request.urlopen(base + "/frame/0.png?ev=2.0").read()
        assert png_ev[:8] == b"\x89PNG\r\n\x1a\n"
        assert png_ev != png  # display-time exposure actually re-tone-maps

        # Appearance-only recommit reuses the accumulation.
        cfg2 = json.loads(json.dumps(cfg))
        cfg2["render"][0]["intensity_factor"] = 2.0
        req = urllib.request.Request(
            base + "/commit", data=json.dumps(cfg2).encode(), method="POST")
        resp = json.loads(urllib.request.urlopen(req).read())
        assert resp["reused"] is True

        # Broken config -> 400, server stays alive.
        req = urllib.request.Request(
            base + "/commit", data=b"{not json", method="POST")
        try:
            urllib.request.urlopen(req)
            assert False, "expected HTTP 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
        status = json.loads(urllib.request.urlopen(base + "/status").read())
        assert status["renders"] == 1
    finally:
        httpd.shutdown()
        gui.server.shutdown()


@pytest.mark.slow
def test_gui_project_roundtrip_and_crystal_mesh():
    """Project save/load + 3D crystal-preview data (the two highest-value
    reference GUI slices: src/gui/file_io.cpp save/load, crystal_renderer
    mesh preview)."""
    from ice_halo_sim_jax.gui.app import serve

    cfg = dict(SMOKE_CFG)
    cfg["scene"] = dict(SMOKE_CFG["scene"], ray_num=8192)
    httpd, gui = serve(json.dumps(cfg), port=0, seed=3, batch_size=4096,
                       block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        gui.server.wait_idle(timeout=300)

        status = json.loads(urllib.request.urlopen(base + "/status").read())
        assert status["crystals"], status

        # Save: the active project serializes to JSON...
        saved = urllib.request.urlopen(base + "/project").read()
        proj = json.loads(saved)
        assert "crystal" in proj and "scene" in proj

        # ...and loading the SAVED project back is a value-equal commit
        # (reused accumulation) — the round-trip contract.
        req = urllib.request.Request(
            base + "/commit", data=saved, method="POST")
        resp = json.loads(urllib.request.urlopen(req).read())
        assert resp["reused"] is True

        # Crystal mesh: closed triangle surface of the committed crystal.
        cid = status["crystals"][0]
        mesh = json.loads(
            urllib.request.urlopen(base + f"/crystal/{cid}.json").read())
        nv, nt = len(mesh["vertices"]), len(mesh["triangles"])
        assert nv >= 8 and nt >= 2 * nv - 4  # closed: T = 2V - 4
        assert all(len(v) == 3 for v in mesh["vertices"])
        assert all(
            0 <= i < nv for tri in mesh["triangles"] for i in tri)

        try:
            urllib.request.urlopen(base + "/crystal/999.json")
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        httpd.shutdown()
        gui.server.shutdown()

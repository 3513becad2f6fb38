"""Multi-host (multi-controller) path: 2 local processes x 4 CPU devices
with a localhost coordinator must reproduce the sequential oracle exactly.

This is the no-hardware stand-in for N GPU hosts over the network — the same
program, coordinator wiring, global mesh, and drain reduction as real
multi-host, minus only the physical interconnect (the reference's
fake-backend testing discipline, doc/testing-architecture.md:264-269).
"""

import json
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.conftest import clean_jax_env

WORKER = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, "/root/repo")
    rank = int(sys.argv[1])
    port = sys.argv[2]

    from ice_halo_sim_jax.parallel.distributed import (
        MultiHostEngine, init_multi_host)
    init_multi_host(f"localhost:{port}", 2, rank)

    import jax
    import numpy as np
    assert jax.process_count() == 2
    assert jax.device_count() == 8, jax.devices()

    from ice_halo_sim_jax.config.loader import load_project
    from tests.test_e2e import SMOKE_CFG

    cfg = load_project(SMOKE_CFG)
    B = 2048
    eng = MultiHostEngine(cfg, seed=13, per_device_batch=B)
    eng.run(n_batches=2)
    xyz = eng.raw_xyz(0)
    print("RESULT " + json.dumps({
        "rank": rank,
        "total": float(xyz.sum()),
        "shape": list(xyz.shape),
        "rays": eng.rays_traced,
        "digest": float(np.abs(xyz).astype(np.float64).sum()
                        + (xyz[::7, ::5].sum() * 3.0)),
    }), flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_mesh_equals_sequential_oracle():
    port = _free_port()
    env = clean_jax_env(4)  # 4 CPU devices per process -> 8 global
    env["IHT_TEST_REEXEC"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd="/root/repo",
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, (out[-2000:], err[-3000:])
        outs.append(out)
    results = [
        json.loads(line[len("RESULT "):])
        for out in outs
        for line in out.splitlines()
        if line.startswith("RESULT ")
    ]
    assert len(results) == 2
    # Both processes drained the same replicated image.
    assert results[0]["digest"] == pytest.approx(results[1]["digest"], rel=1e-7)
    assert results[0]["rays"] == 2 * 8 * 2048

    # Sequential oracle: one single-device engine consuming the same
    # global ray-index space (same construction as tests/test_sharding.py).
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine
    from tests.test_e2e import SMOKE_CFG

    B = 2048
    e = Engine(load_project(SMOKE_CFG), seed=13, batch_size=B)
    e.run(n_batches=1)
    e.reset()
    accum = e.accum
    span = B * (len(e.layers) + 1)
    for counter in range(2):
        for dev in range(8):
            base = (counter * 8 * span + dev * span) & 0xFFFFFFFF
            accum = e._step(accum, np.uint32(base), np.uint32(counter),
                            e._compact_keep, e._plan_version, None)[0]
    p = e.proj_plans[0]
    xyz_ref = np.asarray(accum[0][:, :3]).reshape(p.height, p.width, 3)
    assert results[0]["total"] == pytest.approx(float(xyz_ref.sum()), rel=1e-5)

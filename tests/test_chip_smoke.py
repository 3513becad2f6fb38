"""chip_smoke.py's guards and shared checks, on the CPU.

The script itself needs a GPU; what it decides before touching one (its
arguments, its refusal of a CPU backend) and the physics checks it shares
with the CPU path are tested here."""

import copy

import jax
import pytest

import chip_smoke


def test_refuses_a_cpu_backend():
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        chip_smoke.check_devices(jax.devices("cpu"), 1)
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        chip_smoke.check_devices([], 1)


def test_parse_args_default_and_four_cards():
    assert chip_smoke.parse_args([]).cards == 1
    assert chip_smoke.parse_args(["--cards", "4"]).cards == 4


def test_parse_args_rejects_other_card_counts():
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--cards", "2"])


def test_main_fails_without_gpu_and_prints_no_ok_line(capsys):
    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_ring_anchor_on_light_scene_small_n():
    """The 22-degree ring anchor of phase 1 on the bench scene at 2^19
    rays: peak in [21, 25] deg and a sharp minimum-deviation wall."""
    from ice_halo_sim_jax.config.loader import load_project
    from ice_halo_sim_jax.engine.simulator import Engine

    cfg = load_project(copy.deepcopy(chip_smoke.scene()))
    eng = Engine(cfg, seed=3, batch_size=1 << 16)
    eng.run(total_rays=1 << 19)
    peak, inside, wall = chip_smoke.assert_ring_anchor(eng, cfg)
    assert wall > 5 * inside

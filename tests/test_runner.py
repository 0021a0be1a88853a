"""Runtime-layer tests: FSM, live tuning, reset, metrics, scenes."""

import numpy as np
import pytest

from water_sandbox import Simulation, scenes
from water_sandbox.runtime.runner import SimPhase


def mini():
    return Simulation.from_scene("mini-3d", neighbor_mode="dense")


def test_scene_registry_has_baseline_ladder():
    have = scenes.names()
    for s in ["dam-break-2d-4k", "interactive-2d-16k", "sort-stress-64k",
              "moving-container-256k", "sharded-1m", "reference-cube"]:
        assert s in have


def test_run_pause_resume_reset():
    sim = mini()
    assert sim.phase is SimPhase.READY
    sim.run(3)
    assert int(sim.state.step_count) == 3
    sim.pause()
    assert sim.phase is SimPhase.PAUSED
    sim.run(5)  # gated — like the Paused GameState gating the physics sets
    assert int(sim.state.step_count) == 3
    sim.pause()  # toggle back (Esc semantics, state.rs:34-40)
    sim.run(2)
    assert int(sim.state.step_count) == 5
    p0 = sim.positions()
    sim.reset()
    assert int(sim.state.step_count) == 0
    sim.run(5)
    np.testing.assert_allclose(sim.positions(), p0, rtol=1e-5, atol=1e-6)


def test_reset_twice_works_after_donation():
    sim = mini()
    sim.run(2)
    sim.reset()
    sim.run(2)
    sim.reset()
    sim.run(1)
    assert int(sim.state.step_count) == 1


def test_tune_changes_behavior_without_recompile():
    sim = mini()
    sim.run(2)
    v_before = np.abs(sim.velocities()).mean()
    sim.reset()
    sim.gravity_off()
    sim.tune(pressure_scalar=0.0, near_pressure_scalar=0.0,
             viscosity_strength=0.0)
    sim.run(2)
    # no gravity, no pressure → nothing moves
    assert np.abs(sim.velocities()).max() < 1e-6
    sim.gravity_on()
    sim.run(2)
    assert np.abs(sim.velocities()).max() > 0


def test_tune_field_dict():
    sim = mini()
    sim.tune(field={"position": (0.0, 0.0, 0.0), "strength": 30.0,
                    "radius": 5.0})
    assert float(sim.params.field.strength) == 30.0
    sim.run(1)


def test_stats_and_metrics():
    sim = mini()
    sim.run(5)
    sim.run(5)  # first window may be compile warm-up; this one is warm
    st = sim.stats()
    assert st["step"] == 10
    assert st["kinetic_energy"] > 0
    assert "particle_steps_per_s" in st
    assert st["mean_density"] > 0


def test_metrics_exclude_compile_windows():
    """Rates come from WARM windows only: a window
    that compiled a new rollout program is recorded as warm-up."""
    sim = mini()
    sim.run(5)
    st = sim.stats()
    if st.get("compiles_seen"):   # fresh jit cache in this process
        assert st["steps_timed"] == 0
        assert st["warmup_wall_s"] > 0
        assert "particle_steps_per_s" not in st
    sim.run(5)
    st = sim.stats()
    assert st["steps_timed"] >= 5
    assert st["particle_steps_per_s"] > 0


def test_snapshot_shapes():
    sim = mini()
    sim.run(1)
    snap = sim.snapshot()
    assert snap["pos"].shape == (512, 3)
    assert snap["density"].shape == (512,)


# (scene, axis) pairs whose grid deliberately spans the fluid's depth, not
# the box's height: the flagship's body-frame grid is 32 cells (8 m) tall in
# a 10 m box, since its 4.8 m pool never rises that far (a particle that
# did would clamp into the top cells — exact, only slower)
_DEPTH_TRIMMED = {("moving-container-256k", 1)}


@pytest.mark.parametrize("name", scenes.names())
def test_scene_builds_and_grid_covers_container(name):
    """Every registered scene builds a consistent (cfg, params, state) on
    the production pipeline, and its grid spans its container (in the body
    frame for container-frame scenes) with a cell to spare for the dynamic
    anchor and the prediction lookahead."""
    cfg, params, state = scenes.build(name)
    assert cfg.neighbor_mode == "bucket_grid"
    assert state.pos.shape == (cfg.n, cfg.dim)
    assert params.dim == cfg.dim
    h = float(params.smoothing_radius)
    size = 2.0 * np.asarray(params.container.half_size)
    pos = np.asarray(state.pos) - np.asarray(params.container.center)
    for a, cells in enumerate(cfg.grid_dims):
        need = size[a]
        if (name, a) in _DEPTH_TRIMMED:
            need = pos[:, a].max() + size[a] / 2 + 2 * h
        assert cells * h >= need + 2 * h, (a, cells, need)

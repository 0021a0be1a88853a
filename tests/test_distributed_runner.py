"""DistributedSimulation runtime over the 8-virtual-device mesh + rendering."""

import os

import jax
import numpy as np
import pytest

from water_sandbox.runtime.distributed import DistributedSimulation


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_distributed_sim_runs_and_conserves_particles():
    from water_sandbox.core.params import Container, SimConfig, SimParams
    from water_sandbox.core.state import init_state
    from water_sandbox.models import scenes
    from water_sandbox.runtime.distributed import DistributedSimulation

    pts = scenes.cube_fluid(6, 4, 4)
    params = SimParams.create(
        dim=3, container=Container.create((0, 0, 0), (4.0, 3.0, 3.0)))
    cfg = SimConfig(n=pts.shape[0], dim=3, neighbor_mode="bucket_grid",
                    grid_dims=(24, 16, 16), cell_capacity=16)
    sim = DistributedSimulation(cfg, params, init_state(pts), n_devices=8,
                                slack=8.0)
    sim.run(6)
    st = sim.stats()
    assert st["step"] == 6
    assert st["active_particles"] == cfg.n
    assert st["lost_particles"] == 0.0
    assert sum(st["per_device_counts"]) == cfg.n
    pos, vel = sim.particles()
    assert np.isfinite(pos).all() and np.isfinite(vel).all()

    sim.tune(viscosity_strength=0.5)
    sim.run(2)
    assert sim.stats()["step"] == 8

    # dense-state extraction feeds the ordinary checkpoint machinery
    from water_sandbox.runtime import checkpoint
    dense = sim.to_dense_state()
    assert dense.pos.shape == (cfg.n, 3)
    import tempfile, os as _os
    with tempfile.TemporaryDirectory() as d:
        p = _os.path.join(d, "ck.npz")
        checkpoint.save(p, dense, sim.params, sim.cfg)
        loaded, _, _ = checkpoint.load(p)
        assert loaded.pos.shape == (cfg.n, 3)
        assert int(loaded.step_count) == 8


def test_render_frame_and_gif(tmp_path):
    from water_sandbox import Simulation
    from water_sandbox.io.export import TrajectoryWriter
    from water_sandbox.viz import render

    sim = Simulation.from_scene("mini-3d", neighbor_mode="dense")
    w = TrajectoryWriter(str(tmp_path / "t.npz"))
    for _ in range(3):
        sim.run(2)
        w.add_frame(sim.positions(), float(sim.state.time))
    traj = w.write()

    png = render.render_frame(sim.positions(), sim.velocities(), sim.params,
                              str(tmp_path / "frame.png"))
    assert os.path.getsize(png) > 1000

    gif = render.render_trajectory_gif(traj, str(tmp_path / "anim.gif"),
                                       sim.params, fps=5)
    assert os.path.getsize(gif) > 1000


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_distributed_run_zero_steps_and_lost_accumulation():
    from water_sandbox.core.params import Container, SimConfig, SimParams
    from water_sandbox.core.state import init_state
    from water_sandbox.models import scenes

    pts = scenes.cube_fluid(6, 4, 4)
    params = SimParams.create(
        dim=3, container=Container.create((0, 0, 0), (4.0, 3.0, 3.0)))
    cfg = SimConfig(n=pts.shape[0], dim=3, neighbor_mode="bucket_grid",
                    grid_dims=(24, 16, 16), cell_capacity=16)
    sim = DistributedSimulation(cfg, params, init_state(pts), n_devices=8,
                                slack=8.0)
    sim.run(0)  # must be a no-op, not a NameError
    assert sim.stats()["step"] == 0
    # non-blocking runs must still feed the device-side loss accumulator:
    # stats() reads it back even though run(block=False) never syncs
    sim.run(2, block=False)
    sim.run(2, block=False)
    st = sim.stats()
    assert st["step"] == 4
    assert st["lost_particles"] == 0.0
    assert st["active_particles"] == cfg.n

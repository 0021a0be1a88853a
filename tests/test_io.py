"""Checkpoint, trajectory export, rasterizer, and CLI tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from water_sandbox import Simulation
from water_sandbox.io.export import TrajectoryWriter, load_trajectory
from water_sandbox.runtime import checkpoint
from water_sandbox.viz import raster


def test_checkpoint_roundtrip(tmp_path):
    sim = Simulation.from_scene("mini-3d", neighbor_mode="dense")
    sim.tune(viscosity_strength=0.42)
    sim.run(3)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, sim.state, sim.params, sim.cfg)

    state, params, cfg = checkpoint.load(path)
    assert cfg == sim.cfg
    np.testing.assert_allclose(np.asarray(state.pos),
                               np.asarray(sim.state.pos))
    assert float(params.viscosity_strength) == pytest.approx(0.42)

    # resumed trajectory == continuous trajectory
    sim2 = Simulation(cfg, params, state)
    sim2.run(3)
    sim.run(3)
    np.testing.assert_allclose(np.asarray(sim2.state.pos),
                               np.asarray(sim.state.pos), rtol=1e-6)


def test_trajectory_export_roundtrip(tmp_path):
    sim = Simulation.from_scene("mini-3d", neighbor_mode="dense")
    w = TrajectoryWriter(str(tmp_path / "traj.npz"), {"scene": "mini-3d"})
    w.add_frame(sim.positions(), 0.0)
    sim.run(2)
    w.add_frame(sim.positions(), float(sim.state.time))
    path = w.write()

    positions, times, meta = load_trajectory(path)
    assert positions.shape == (2, 512, 3)
    assert meta["scene"] == "mini-3d"
    assert times[1] > times[0]


def test_density_raster():
    sim = Simulation.from_scene("mini-3d", neighbor_mode="dense")
    sim.run(2)
    img = np.asarray(raster.density_image(sim.state, sim.params, 64, 36))
    assert img.shape == (36, 64)
    assert img.sum() > 0
    # mass should be concentrated where the cube is (center of the image)
    assert img[:, 24:40].sum() > img[:, :16].sum()
    txt = raster.ascii_preview(img)
    assert len(txt.splitlines()) == 36

    simg = np.asarray(raster.speed_image(sim.state, sim.params, 32, 18))
    assert simg.shape == (18, 32)


def test_cli_end_to_end(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    ck = str(tmp_path / "end.npz")
    out = subprocess.run(
        [sys.executable, "-m", "water_sandbox.cli", "run",
         "--scene", "mini-3d", "--neighbor-mode", "dense", "--steps", "4",
         "--record-every", "2", "--checkpoint", ck],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    stats_line = [l for l in out.stdout.splitlines() if l.startswith("{")][0]
    stats = json.loads(stats_line)
    assert stats["step"] == 4
    assert os.path.exists(ck)

    out2 = subprocess.run(
        [sys.executable, "-m", "water_sandbox.cli", "resume",
         "--checkpoint", ck, "--steps", "2"],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out2.returncode == 0, out2.stderr
    stats2 = json.loads(
        [l for l in out2.stdout.splitlines() if l.startswith("{")][0])
    assert stats2["step"] == 6


def test_checkpoint_from_before_kernel_removal_loads(tmp_path):
    """A checkpoint whose config names the removed kernel options (and the
    removed 'pallas' mode) loads onto the bucket_grid pipeline: those were
    layout choices, not physics."""
    sim = Simulation.from_scene("mini-3d", neighbor_mode="dense")
    path = str(tmp_path / "old.npz")
    checkpoint.save(path, sim.state, sim.params, sim.cfg)
    data = dict(np.load(path))
    cfg = json.loads(str(data["config_json"]))
    cfg.update(neighbor_mode="pallas", grid_dims=[20, 16, 16],
               incremental_rebuild=0, mover_capacity=0, sorted_state=True,
               tile_override=1024, build_scatter="stack", density_gate=[],
               force_gate=[], dma_prefetch=True, flush_gated=True)
    data["config_json"] = np.asarray(json.dumps(cfg))
    np.savez_compressed(path, **data)

    state, params, cfg2 = checkpoint.load(path)
    assert cfg2.neighbor_mode == "bucket_grid"
    assert cfg2.grid_dims == (20, 16, 16)
    assert not hasattr(cfg2, "sorted_state")
    np.testing.assert_array_equal(np.asarray(state.pos),
                                  np.asarray(sim.state.pos))
    Simulation(cfg2, params, state).run(1)


@pytest.mark.parametrize("mode", ["pallas", "auto"])
def test_removed_neighbor_modes_are_refused(mode):
    from water_sandbox.core.params import SimConfig
    with pytest.raises(ValueError, match="bucket_grid"):
        SimConfig(n=64, dim=3, neighbor_mode=mode, grid_dims=(8, 8, 8))

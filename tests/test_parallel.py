"""Multi-chip tests on the 8-virtual-device CPU mesh (conftest.py):
sharded trajectories must match single-device ones (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from water_sandbox.core.params import SimConfig, SimParams
from water_sandbox.core.state import init_state
from water_sandbox.models import scenes
from water_sandbox.ops import step as step_mod
from water_sandbox.parallel import gspmd, mesh as mesh_mod


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def small_setup():
    pts = scenes.cube_fluid(8, 6, 6)  # 288 particles
    n = pts.shape[0]
    params = SimParams.create(dim=3)
    cfg = SimConfig(n=n, dim=3, neighbor_mode="bucket_grid",
                    grid_dims=(16, 12, 12), cell_capacity=16)
    return cfg, params, init_state(pts)


def test_mesh_creation():
    mesh = mesh_mod.make_mesh(8)
    assert mesh.devices.size == 8


def test_sharded_matches_single_device():
    cfg, params, state = small_setup()
    mesh = mesh_mod.make_mesh(8)

    s_single = state
    for _ in range(5):
        s_single = step_mod.step(s_single, params, cfg)

    rollout = gspmd.make_sharded_rollout(mesh, cfg)
    s_shard = gspmd.shard_state(state, mesh)
    s_shard = rollout(s_shard, params, 5)

    np.testing.assert_allclose(np.asarray(s_shard.pos),
                               np.asarray(s_single.pos), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_shard.vel),
                               np.asarray(s_single.vel), rtol=1e-3, atol=1e-4)


def test_sharded_rollout_rejects_bad_split():
    cfg, params, state = small_setup()
    cfg = SimConfig(n=cfg.n, dim=3, neighbor_mode="bucket_grid",
                    grid_dims=(15, 12, 12), cell_capacity=16)
    mesh = mesh_mod.make_mesh(8)
    with pytest.raises(ValueError, match="not divisible"):
        gspmd.make_sharded_rollout(mesh, cfg)


def _sharded_step_hlo(grid_dims, lattice, cap=16):
    """Compiled HLO text of one sharded step at the given grid."""
    pts = scenes.cube_fluid(*lattice)
    cfg = SimConfig(n=pts.shape[0], dim=3, neighbor_mode="bucket_grid",
                    grid_dims=grid_dims, cell_capacity=cap)
    params = SimParams.create(dim=3)
    mesh = mesh_mod.make_mesh(8)
    state = gspmd.shard_state(init_state(pts), mesh)
    rollout = gspmd.make_sharded_rollout(mesh, cfg)
    lowered = jax.jit(
        lambda s, p: rollout(s, p, 1)).lower(state, params)
    return lowered.compile().as_text()


def test_gspmd_lowers_rolls_to_collective_permute():
    """The gspmd docstring claims the neighbor rolls lower to one-slab halo
    collective-permutes between mesh neighbors (not all-gathers of the whole
    cell grid). That claim was FALSE until the offset loop was statically
    unrolled for the sharded path (ops/grid.py::_offset_fold): with traced
    roll shifts the SPMD partitioner all-gathered stacked cell planes (e.g.
    f32[4,16,32768] — 8 MiB, 8x a single plane) every pass. Verify on a
    realistically-proportioned grid: collective-permutes must be present and
    every remaining all-gather must be at most ONE (cap, nc) plane — the
    per-particle gather-back legitimately repartitions plane-sharded results
    to the particle axis; grid replication would gather stacked planes."""
    import re

    hlo = _sharded_step_hlo((64, 16, 16), (16, 12, 12))
    n_cp = hlo.count("collective-permute")
    # 26 nonzero neighbor offsets in 2 passes, each needing at least one
    # boundary exchange; fused/deduped counts vary, so just require plenty
    assert n_cp >= 26, f"only {n_cp} collective-permutes — halo exchange " \
        "did not lower to ICI collective-permutes"

    plane_bytes = 16 * 64 * 16 * 16 * 4  # (cap, nc) f32 = 1 MiB
    for m in re.finditer(r"all-gather[^=]*=\s*\(?[fs]32\[([\d,]+)\]", hlo):
        shape = [int(x) for x in m.group(1).split(",")]
        size = 4
        for s in shape:
            size *= s
        assert size <= plane_bytes, (
            f"all-gather of {size} bytes (> one plane) suggests grid "
            f"replication: {m.group(0)[:120]}")

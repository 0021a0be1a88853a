"""Grid-pipeline correctness: both neighbor modes against the dense oracle,
plus structural invariants of the bucket/hash tables (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from water_sandbox.core.params import KernelCoeffs, SimConfig, SimParams
from water_sandbox.core.state import init_state
from water_sandbox.models import scenes
from water_sandbox.ops import dense, grid as grid_mod, hashing
from water_sandbox.ops import step as step_mod


def make_inputs(dim=3, seed=0, n=300, spread=3.0, velocity_scale=1.0):
    """Random particle cloud inside the default container."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    pred = (jax.random.uniform(k1, (n, dim)) - 0.5) * spread
    vel = jax.random.normal(k2, (n, dim)) * velocity_scale
    return pred.astype(jnp.float32), vel.astype(jnp.float32)


def grid_cfg(n, dim, mode, **kw):
    # test clouds span ~3 m; a 16-cell grid keeps the CPU cost of the dense
    # bucket math tiny (the grid is dynamically anchored, so only coverage
    # matters, not absolute coordinates)
    dims = (16,) * dim
    base = dict(n=n, dim=dim, neighbor_mode=mode, grid_dims=dims,
                cell_capacity=32, chunk=64, max_run=64)
    base.update(kw)
    return SimConfig(**base)


@pytest.mark.parametrize("dim", [2, 3])
def test_bucket_grid_matches_dense(dim):
    pred, vel = make_inputs(dim=dim)
    n = pred.shape[0]
    params = SimParams.create(dim=dim)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = grid_cfg(n, dim, "bucket_grid")

    d, nd, p, np_, acc, overflow = grid_mod.bucket_sph(pred, vel, params,
                                                       coeffs, cfg)
    assert int(overflow) == 0

    d_ref, nd_ref, p_ref, np_ref = dense.density_pass(pred, params, coeffs)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(nd), np.asarray(nd_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_ref), rtol=1e-4,
                               atol=1e-4)

    acc_ref = dense.force_pass(pred, vel, d_ref, nd_ref, p_ref, np_ref,
                               params, coeffs)
    np.testing.assert_allclose(np.asarray(acc), np.asarray(acc_ref),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_hash_grid_matches_weighted_dense(dim):
    """The hash_grid pipeline must reproduce the reference's hash-collision
    multi-count semantics exactly — validated against the dense oracle
    weighted by reference_pair_weights."""
    pred, vel = make_inputs(dim=dim, seed=1)
    n = pred.shape[0]
    params = SimParams.create(dim=dim)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = grid_cfg(n, dim, "hash_grid")

    w = hashing.reference_pair_weights(pred, params.smoothing_radius,
                                       cfg.table_size)
    assert int(jnp.max(w)) >= 1

    d, nd, p, np_, acc, _ = grid_mod.hash_sph(pred, vel, params, coeffs, cfg)
    d_ref, nd_ref, p_ref, np_ref = dense.density_pass(pred, params, coeffs,
                                                      pair_weight=w)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(nd), np.asarray(nd_ref), rtol=1e-5)

    acc_ref = dense.force_pass(pred, vel, d_ref, nd_ref, p_ref, np_ref,
                               params, coeffs, pair_weight=w)
    np.testing.assert_allclose(np.asarray(acc), np.asarray(acc_ref),
                               rtol=2e-4, atol=2e-4)


def test_bucket_is_valid_partition():
    """Every particle lands in exactly one bucket slot (no overflow) and its
    addr points at its own position."""
    pred, vel = make_inputs(dim=3, seed=2)
    params = SimParams.create(dim=3)
    cfg = grid_cfg(pred.shape[0], 3, "bucket_grid")
    g = grid_mod.build_bucket_grid(pred, vel, params, cfg)
    assert int(g.overflow) == 0
    mask = np.asarray(g.cell_mask)
    assert mask.sum() == cfg.n
    # cell_pos is (dim, C, nc); addr indexes the flattened (C·nc) plane
    flat_pos = np.asarray(g.cell_pos).reshape(3, -1)
    addr = np.asarray(g.addr)
    np.testing.assert_allclose(flat_pos[:, addr].T, np.asarray(pred),
                               rtol=1e-6)


def test_hash_sort_is_valid_permutation():
    pred, _ = make_inputs(dim=3, seed=3)
    params = SimParams.create(dim=3)
    cfg = grid_cfg(pred.shape[0], 3, "hash_grid")
    g = grid_mod.build_hash_grid(pred, params, cfg)
    order = np.asarray(g.order)
    assert sorted(order.tolist()) == list(range(cfg.n))
    keys = np.asarray(g.sorted_keys)
    assert (np.diff(keys) >= 0).all()
    # starts = first rank of each key (atomicMin semantics,
    # bitonic_sort.wgsl:49-59)
    starts = np.asarray(g.starts)
    for k in np.unique(keys):
        assert starts[k] == int(np.argmax(keys == k))


def test_cell_capacity_overflow_counted():
    """Cram 100 particles into one cell: overflow = n - capacity, physics
    still finite."""
    pred = jnp.zeros((100, 3), jnp.float32) + 0.01
    vel = jnp.zeros((100, 3), jnp.float32)
    params = SimParams.create(dim=3)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, 3)
    cfg = grid_cfg(100, 3, "bucket_grid", cell_capacity=8)
    d, nd, p, np_, acc, overflow = grid_mod.bucket_sph(pred, vel, params,
                                                       coeffs, cfg)
    assert int(overflow) == 100 - 8
    assert np.isfinite(np.asarray(acc)).all()
    assert np.isfinite(np.asarray(d)).all()


@pytest.mark.parametrize("mode", ["bucket_grid", "hash_grid"])
def test_grid_step_matches_dense_step_trajectory(mode):
    """Full multi-step trajectories agree between grid modes and the dense
    oracle (hash mode agrees where no collision multi-count occurs — use a
    hash table large enough to make collisions vanish for this cloud)."""
    pts = scenes.cube_fluid(6, 6, 6)
    n = pts.shape[0]
    params = SimParams.create(dim=3)
    cfg_d = SimConfig(n=n, dim=3, neighbor_mode="dense")
    kw = {}
    if mode == "hash_grid":
        kw["hash_table_size"] = 1 << 18  # collisions ~impossible at n=216
    cfg_g = grid_cfg(n, 3, mode, chunk=128, cell_capacity=16, **kw)

    s_d = init_state(pts)
    s_g = init_state(pts)
    for _ in range(10):
        s_d = step_mod.step(s_d, params, cfg_d)
        s_g = step_mod.step(s_g, params, cfg_g)
    np.testing.assert_allclose(np.asarray(s_g.pos), np.asarray(s_d.pos),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(s_g.vel), np.asarray(s_d.vel),
                               rtol=1e-3, atol=1e-3)


def test_non_power_of_two_n():
    """The reference only supports power-of-two N (FIXME,
    src/fluid_compute.rs:15); we support any N."""
    pred, vel = make_inputs(dim=3, seed=4, n=237)
    params = SimParams.create(dim=3)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, 3)
    for mode in ["bucket_grid", "hash_grid"]:
        cfg = grid_cfg(237, 3, mode)
        fn = grid_mod.bucket_sph if mode == "bucket_grid" else grid_mod.hash_sph
        d, nd, p, np_, acc, _ = fn(pred, vel, params, coeffs, cfg)
        assert np.isfinite(np.asarray(d)).all()
        assert np.isfinite(np.asarray(acc)).all()


def test_reference_hash_u32_wraparound():
    """Negative cell coords must wrap exactly like WGSL's vec3<u32> bitcast
    (simulation.wgsl:125-128)."""
    cell = jnp.asarray([[-1, -2, -3]], jnp.int32)
    key = hashing.reference_hash(cell, 65536)
    x = np.uint32(np.int64(-1) & 0xFFFFFFFF)
    y = np.uint32(np.int64(-2) & 0xFFFFFFFF)
    z = np.uint32(np.int64(-3) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        expected = (x * np.uint32(hashing.P1) + y * np.uint32(hashing.P2)
                    + z * np.uint32(hashing.P3)) % np.uint32(65536)
    assert int(key[0]) == int(expected)


def test_bucket_grid_wraparound_is_masked_by_distance():
    """Particles pinned to opposite grid borders must not interact through
    jnp.roll wraparound."""
    pred = jnp.asarray([[-7.9, 0.0, 0.0], [7.9, 0.0, 0.0]], jnp.float32)
    vel = jnp.zeros((2, 3), jnp.float32)
    params = SimParams.create(dim=3)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, 3)
    cfg = grid_cfg(2, 3, "bucket_grid", grid_dims=(68, 4, 4), cell_capacity=4)
    d, nd, p, np_, acc, _ = grid_mod.bucket_sph(pred, vel, params, coeffs, cfg)
    # each sees only itself
    h = float(params.smoothing_radius)
    expected = h * h * float(coeffs.pow2) + 1e-5
    np.testing.assert_allclose(np.asarray(d), expected, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(acc), 0.0, atol=1e-6)


def test_hash_run_truncation_is_counted():
    """A same-hash run longer than max_run must be surfaced in
    HashGrid.overflow (the reference walks runs unboundedly,
    simulation.wgsl:167-183; our emulation walks at most max_run)."""
    n = 40
    pred = jnp.zeros((n, 3), jnp.float32) + 0.01  # all in one cell → one run
    params = SimParams.create(dim=3)
    cfg = grid_cfg(n, 3, "hash_grid", max_run=8)
    g = grid_mod.build_hash_grid(pred, params, cfg)
    assert int(g.overflow) == n - 8
    # spread cloud with default max_run: no truncation
    pred2, _ = make_inputs(dim=3, seed=5)
    cfg2 = grid_cfg(pred2.shape[0], 3, "hash_grid")
    g2 = grid_mod.build_hash_grid(pred2, params, cfg2)
    assert int(g2.overflow) == 0


def test_grid_dims_required_for_bucket_modes():
    with pytest.raises(ValueError, match="grid_dims"):
        SimConfig(n=64, dim=3, neighbor_mode="bucket_grid")
    # bucket_grid is the default mode, so it needs grid_dims too
    with pytest.raises(ValueError, match="grid_dims"):
        SimConfig(n=64, dim=3)
    with pytest.raises(ValueError, match="grid_dims"):
        SimConfig(n=64, dim=2, neighbor_mode="bucket_grid",
                  grid_dims=(8, 8, 8))
    # dense and hash_grid need no grid
    SimConfig(n=64, dim=3, neighbor_mode="dense")
    SimConfig(n=64, dim=3, neighbor_mode="hash_grid")


def test_trajectory_rejects_indivisible_record_every():
    pts = scenes.cube_fluid(4, 4, 4)
    params = SimParams.create(dim=3)
    cfg = SimConfig(n=pts.shape[0], dim=3, neighbor_mode="dense")
    with pytest.raises(ValueError, match="divisible"):
        step_mod.trajectory(init_state(pts), params, cfg, 7, 2)


def test_key_coords_container_frame_is_comoving():
    """Points rigidly attached to a translating+yawing box must have
    TIME-INVARIANT container-frame key coordinates (ops/hashing.py::
    key_coords) — this pins the pose plumbing (center + yaw at sim time
    t), which exactness cannot catch: ANY isometric key frame gives
    correct physics, but a wrong pose would silently un-trim the
    body-frame grid the flagship scene relies on."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from water_sandbox.core.params import (Container, SimConfig,
                                               SimParams)
    from water_sandbox.ops import hashing
    from water_sandbox.ops import integrate as integrate_mod

    container = Container.create(
        center=(1.0, -0.5, 0.25), size=(4.0, 2.0, 3.0),
        velocity=(0.3, 0.0, -0.1), angular_velocity=0.7, angle=0.2)
    params = SimParams.create(dim=3, container=container)
    cfg = SimConfig(n=8, dim=3, neighbor_mode="bucket_grid",
                    grid_dims=(8, 8, 8), cell_capacity=8,
                    grid_frame="container")

    body_pts = (np.random.RandomState(0).rand(8, 3) - 0.5).astype(
        np.float32)
    ref = None
    for t in (0.0, 0.9, 2.3):
        t = jnp.asarray(t, jnp.float32)
        center, angle = integrate_mod.container_at(container, t)
        world = integrate_mod._rotate_yaw(
            jnp.asarray(body_pts), angle) + center
        kc = np.asarray(hashing.key_coords(world, params, cfg, t))
        if ref is None:
            ref = kc
        else:
            np.testing.assert_allclose(kc, ref, rtol=0, atol=3e-6)
    # world frame: key_coords is the identity and needs no time
    cfg_w = dataclasses.replace(cfg, grid_frame="world")
    w = jnp.asarray(body_pts)
    assert hashing.key_coords(w, params, cfg_w, None) is w

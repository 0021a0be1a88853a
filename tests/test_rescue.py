"""Overflow-rescue exactness: a scene forced to overflow its cell buckets
must still match the dense O(N²) oracle everywhere — complete physics
cannot drop particles."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from water_sandbox.core.params import KernelCoeffs, SimConfig, SimParams
from water_sandbox.models.scenes import cube_fluid
from water_sandbox.ops import dense, grid, step as step_mod
from water_sandbox.core.state import init_state


@pytest.fixture(scope="module")
def crowded():
    """A 2-D blob whose cells hold far more than the tiny test capacity."""
    pts = cube_fluid(24, 18, None, particle_radius=0.04)
    params = SimParams.create(dim=2, container=jnp.asarray)  # placeholder
    params = SimParams.create(dim=2)
    state = init_state(pts)
    # a couple of dense steps to get irregular positions + velocities
    cfg_d = SimConfig(n=pts.shape[0], dim=2, neighbor_mode="dense")
    state = step_mod.rollout(state, params, cfg_d, 5)
    return state, params


def _fields(state, params, cfg):
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    return grid.bucket_sph(state.predicted, state.vel, params, coeffs, cfg)


def _dense_fields(state, params, cfg):
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    den, nden, prs, nprs = dense.density_pass(state.predicted, params, coeffs)
    acc = dense.force_pass(state.predicted, state.vel, den, nden, prs, nprs,
                           params, coeffs)
    return den, nden, prs, nprs, acc


def test_rescue_matches_dense_oracle(crowded):
    state, params = crowded
    n = state.n
    cfg = SimConfig(n=n, dim=2, neighbor_mode="bucket_grid",
                    grid_dims=(40, 40), cell_capacity=4,
                    rescue_capacity=512, chunk=128)
    den, nden, prs, nprs, acc, unrescued = _fields(state, params, cfg)

    # capacity 4 must actually overflow this blob, and rescue must cover it
    cfg_plain = dataclasses.replace(cfg, rescue_capacity=0)
    *_, raw_overflow = _fields(state, params, cfg_plain)
    assert int(raw_overflow) > 0, "test scene must force overflow"
    assert int(unrescued) == 0

    dden, dnden, dprs, dnprs, dacc = _dense_fields(state, params, cfg)
    np.testing.assert_allclose(den, dden, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(nden, dnden, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(acc, dacc, rtol=2e-4, atol=2e-3)


def test_rescue_budget_exceeded_is_counted(crowded):
    """Beyond-budget overflow must stay counted AND harmless: pairs touching
    unrescued particles are excluded from the sweep (their fill densities
    would otherwise amplify forces ~1e5x — the round-2 detonation bug)."""
    state, params = crowded
    cfg = SimConfig(n=state.n, dim=2, neighbor_mode="bucket_grid",
                    grid_dims=(40, 40), cell_capacity=2,
                    rescue_capacity=8, chunk=128)
    den, nden, prs, nprs, acc, unrescued = _fields(state, params, cfg)
    assert int(unrescued) > 0          # budget deliberately too small
    assert np.isfinite(np.asarray(den)).all()
    assert np.isfinite(np.asarray(acc)).all()

    # accelerations must stay at the physical scale of the rescue-disabled
    # pipeline — not orders of magnitude above it
    cfg0 = dataclasses.replace(cfg, rescue_capacity=0)
    *_, acc0, _ = _fields(state, params, cfg0)
    a_max = float(np.linalg.norm(np.asarray(acc), axis=1).max())
    a0_max = float(np.linalg.norm(np.asarray(acc0), axis=1).max())
    dmax = float(np.asarray(den).max())
    d0max = float(np.asarray(_dense_fields(state, params, cfg)[0]).max())
    assert a_max < 20 * max(a0_max, 1.0), (a_max, a0_max)
    assert dmax < 2 * d0max + 100.0


def test_no_overflow_means_no_rescue_cost_difference(crowded):
    """With ample capacity the cond must take the cheap branch and results
    must equal the rescue-disabled pipeline exactly."""
    state, params = crowded
    base = SimConfig(n=state.n, dim=2, neighbor_mode="bucket_grid",
                     grid_dims=(40, 40), cell_capacity=32, chunk=128)
    with_r = dataclasses.replace(base, rescue_capacity=256)
    a = _fields(state, params, base)
    b = _fields(state, params, with_r)
    assert int(a[-1]) == 0 and int(b[-1]) == 0
    for x, y in zip(a[:-1], b[:-1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("grid_frame", ["world", "container"])
@pytest.mark.parametrize("dim", [2, 3])
def test_rescue_matches_dense_oracle_in_key_frames(dim, grid_frame):
    """Forced overflow through bucket_grid, in both key frames (the
    container frame with a translating+yawing box at t != 0): the rescue
    keeps every field on the dense oracle."""
    from water_sandbox.core.params import Container

    nk = 8 if dim == 3 else None
    pts = cube_fluid(12 if dim == 2 else 8, 8, nk, particle_radius=0.04)
    rng = np.random.RandomState(dim)
    pred = jnp.asarray(np.asarray(pts) + rng.randn(*pts.shape) * 0.01,
                       jnp.float32)
    vel = jnp.asarray(rng.randn(*pts.shape), jnp.float32)
    container = Container.create(
        center=(0.1,) * dim, size=(3.0,) * dim,
        velocity=(0.4,) + (0.0,) * (dim - 1), angular_velocity=0.5,
        angle=0.2)
    params = SimParams.create(dim=dim, container=container)
    n = pred.shape[0]
    cfg = SimConfig(n=n, dim=dim, neighbor_mode="bucket_grid",
                    grid_dims=(12,) * dim, cell_capacity=4,
                    rescue_capacity=n, chunk=128, grid_frame=grid_frame)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    t = jnp.asarray(1.3, jnp.float32)

    *_, raw_overflow = grid.bucket_sph(
        pred, vel, params, coeffs,
        dataclasses.replace(cfg, rescue_capacity=0), time=t)
    assert int(raw_overflow) > 0, "test cloud must force overflow"
    den, nden, prs, nprs, acc, unrescued = grid.bucket_sph(
        pred, vel, params, coeffs, cfg, time=t)
    assert int(unrescued) == 0

    dden, dnden, dprs, dnprs = dense.density_pass(pred, params, coeffs)
    dacc = dense.force_pass(pred, vel, dden, dnden, dprs, dnprs, params,
                            coeffs)
    np.testing.assert_allclose(den, dden, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(nden, dnden, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(acc, dacc, rtol=2e-4, atol=2e-3)

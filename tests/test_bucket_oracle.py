"""The production bucket_grid step against the dense oracle step, over the
axes the scenes exercise: dimension, key frame (world / container body
frame), container motion (static / translating + yawing, at t != 0) and
the interaction field (off / on). Also the container-frame step and
rollout on a grid sized to the box's body frame."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from water_sandbox.core.params import (Container, InteractionField,
                                       SimConfig, SimParams)
from water_sandbox.core.state import init_state
from water_sandbox.models.scenes import cube_fluid
from water_sandbox.ops import integrate as integrate_mod
from water_sandbox.ops import step as step_mod

T0 = 1.7  # sim time of the compared step: the moving box is posed, not home


def _container(dim, moving):
    center = (0.3, -0.1, 0.2)[:dim]
    kw = {}
    if moving:
        kw = dict(velocity=(0.5, 0.0, -0.2)[:dim], angular_velocity=0.4,
                  angle=0.3)
    return Container.create(center=center, size=(3.0,) * dim, **kw)


def _state_in_box(dim, container, params, n=200, seed=0):
    """n particles inside the box posed at T0, with random velocities and
    predicted = pos + vel·lookahead (the state a step starts from)."""
    rng = np.random.RandomState(seed)
    body = (rng.rand(n, dim) - 0.5) * 2.6
    t = jnp.asarray(T0, jnp.float32)
    center, angle = integrate_mod.container_at(container, t)
    pos = integrate_mod._rotate_yaw(jnp.asarray(body, jnp.float32),
                                    angle) + center
    vel = jnp.asarray(rng.randn(n, dim), jnp.float32)
    state = init_state(pos, vel)
    return dataclasses.replace(state, predicted=pos + vel * params.lookahead,
                               time=t)


@pytest.mark.parametrize("field", ["off", "on"])
@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
@pytest.mark.parametrize("grid_frame", ["world", "container"])
@pytest.mark.parametrize("dim", [2, 3])
def test_bucket_step_matches_dense_step(dim, grid_frame, moving, field):
    container = _container(dim, moving)
    kw = {}
    if field == "on":
        kw["field"] = InteractionField.create((0.2,) * dim, strength=15.0,
                                              radius=1.5)
    params = SimParams.create(dim=dim, container=container, **kw)
    state = _state_in_box(dim, container, params)
    n = state.n
    cfg_b = SimConfig(n=n, dim=dim, neighbor_mode="bucket_grid",
                      grid_dims=(20,) * dim, cell_capacity=16,
                      grid_frame=grid_frame)
    cfg_d = SimConfig(n=n, dim=dim, neighbor_mode="dense")

    got = step_mod.step(state, params, cfg_b)
    want = step_mod.step(state, params, cfg_d)

    assert int(got.overflow) == 0
    np.testing.assert_allclose(got.density, want.density, rtol=1e-5)
    np.testing.assert_allclose(got.near_density, want.near_density,
                               rtol=1e-5)
    np.testing.assert_allclose(got.pressure, want.pressure, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.acc, want.acc, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.vel, want.vel, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.pos, want.pos, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_container_frame_step_rollout(dim):
    """grid_frame='container' threads state.time into the bucket build
    (ops/step.py): single steps then a rollout, with a translating+yawing
    box, stay finite, inside the box and overflow-free on a grid sized to
    the box's BODY frame."""
    nk = 6 if dim == 3 else None
    pts = cube_fluid(6, 6, nk, particle_radius=0.1)
    container = Container.create(
        center=(0.0,) * dim, size=(3.0,) * dim,
        velocity=(0.2,) + (0.0,) * (dim - 1), angular_velocity=0.3)
    params = SimParams.create(dim=dim, container=container)
    cfg = SimConfig(n=pts.shape[0], dim=dim, neighbor_mode="bucket_grid",
                    grid_dims=(14,) * dim, cell_capacity=16,
                    grid_frame="container")
    state = init_state(pts)
    for _ in range(3):
        state = step_mod.step(state, params, cfg)
    state = step_mod.rollout(state, params, cfg, 3)

    assert int(state.step_count) == 6
    pos = np.asarray(state.pos)
    assert np.isfinite(pos).all()
    center, angle = integrate_mod.container_at(container, state.time)
    local = np.asarray(integrate_mod._rotate_yaw(
        jnp.asarray(pos) - center, angle, inverse=True))
    assert (np.abs(local) <= 1.5 + 1e-4).all()
    assert float(np.asarray(state.overflow_total)) == 0.0

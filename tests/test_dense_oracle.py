"""Dense-oracle physics invariants (SURVEY.md §4 test plan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from water_sandbox.core.params import KernelCoeffs, SimConfig, SimParams
from water_sandbox.core.state import init_state
from water_sandbox.models import scenes
from water_sandbox.ops import dense, step as step_mod


def small_scene(dim=3, n_side=6):
    if dim == 3:
        pts = scenes.cube_fluid(n_side, n_side, n_side)
    else:
        pts = scenes.cube_fluid(n_side * 2, n_side * 2, None)
    params = SimParams.create(dim=dim)
    cfg = SimConfig(n=pts.shape[0], dim=dim, neighbor_mode="dense")
    return cfg, params, init_state(pts)


def test_density_includes_self_and_padding():
    """A lone particle has density = W(0) + padding (simulation.wgsl:187-188)."""
    params = SimParams.create(dim=3)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, 3)
    pred = jnp.zeros((1, 3), jnp.float32)
    d, nd, p, np_ = dense.density_pass(pred, params, coeffs)
    h = float(params.smoothing_radius)
    expected = h * h * float(coeffs.pow2) + 1e-5
    assert np.isclose(float(d[0]), expected, rtol=1e-5)
    expected_near = h**3 * float(coeffs.pow3) + 1e-5
    assert np.isclose(float(nd[0]), expected_near, rtol=1e-5)
    # EOS (simulation.wgsl:192-194)
    assert np.isclose(float(p[0]),
                      float(params.pressure_scalar) * (float(d[0]) - 10.0),
                      rtol=1e-5)
    assert np.isclose(float(np_[0]), 2.0 * float(nd[0]), rtol=1e-5)


def test_pair_force_antisymmetric():
    """Pressure+viscosity accelerations conserve momentum for a pair at
    d > 0 (force is pairwise antisymmetric; gravity excluded)."""
    params = SimParams.create(dim=3)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, 3)
    pred = jnp.asarray([[0.0, 0.0, 0.0], [0.12, 0.05, -0.03]], jnp.float32)
    vel = jnp.asarray([[0.3, 0.0, 0.1], [-0.2, 0.4, 0.0]], jnp.float32)
    d, nd, p, npress = dense.density_pass(pred, params, coeffs)
    acc = dense.force_pass(pred, vel, d, nd, p, npress, params, coeffs)
    # equal mass, equal density for a symmetric pair → acc_i = -acc_j
    np.testing.assert_allclose(np.asarray(acc[0]), -np.asarray(acc[1]),
                               rtol=1e-5, atol=1e-6)


def test_momentum_conserved_dense_step():
    """Total momentum changes only by gravity impulse when no wall is hit."""
    cfg, params, state = small_scene()
    params = params.replace(gravity=jnp.zeros(3))
    s1 = step_mod.step(state, params, cfg)
    p0 = np.asarray(jnp.sum(state.vel, axis=0))
    p1 = np.asarray(jnp.sum(s1.vel, axis=0))
    np.testing.assert_allclose(p1, p0, atol=5e-3)


@pytest.mark.parametrize("dim", [2, 3])
def test_particles_stay_inside_container(dim):
    cfg, params, state = small_scene(dim=dim)
    for _ in range(5):
        state = step_mod.rollout(state, params, cfg, 10)
    pos = np.asarray(state.pos)
    lo = np.asarray(params.container.center - params.container.half_size)
    hi = np.asarray(params.container.center + params.container.half_size)
    pad = float(params.particle_radius)
    assert (pos >= lo + pad - 1e-4).all()
    assert (pos <= hi - pad + 1e-4).all()


def test_zero_distance_fallback_direction_is_up():
    """Two coincident particles repel along +y (simulation.wgsl:243-248)."""
    params = SimParams.create(dim=3)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, 3)
    pred = jnp.zeros((2, 3), jnp.float32)
    vel = jnp.zeros((2, 3), jnp.float32)
    d, nd, p, npress = dense.density_pass(pred, params, coeffs)
    acc = dense.force_pass(pred, vel, d, nd, p, npress, params, coeffs)
    a = np.asarray(acc)
    assert a[0, 0] == 0.0 and a[0, 2] == 0.0
    assert a[0, 1] != 0.0
    # both get the same fallback dir (+y) — faithful to the reference, which
    # does NOT antisymmetrize the d == 0 case
    np.testing.assert_allclose(a[0], a[1])


def test_finite_after_many_steps():
    cfg, params, state = small_scene()
    state = step_mod.rollout(state, params, cfg, 100)
    assert np.isfinite(np.asarray(state.pos)).all()
    assert np.isfinite(np.asarray(state.vel)).all()


@pytest.mark.parametrize("block", [64, 96], ids=["divides", "ragged"])
@pytest.mark.parametrize("dim", [2, 3])
def test_blocked_oracle_matches_dense(dim, block):
    """The row-blocked oracle (what reaches full scene widths) computes the
    same fields as the (n, n) oracle, whether or not the block size
    divides n."""
    n = 320
    rng = np.random.RandomState(dim)
    pred = jnp.asarray((rng.rand(n, dim) - 0.5) * 2.5, jnp.float32)
    vel = jnp.asarray(rng.randn(n, dim), jnp.float32)
    params = SimParams.create(dim=dim)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)

    want = dense.density_pass(pred, params, coeffs)
    got = dense.density_pass_blocked(pred, params, coeffs, block=block)
    for g, w in zip(got, want):
        assert g.shape == (n,)
        np.testing.assert_allclose(g, w, rtol=1e-5)

    acc_want = dense.force_pass(pred, vel, *want, params, coeffs)
    acc_got = dense.force_pass_blocked(pred, vel, *want, params, coeffs,
                                       block=block)
    assert acc_got.shape == (n, dim)
    np.testing.assert_allclose(acc_got, acc_want, rtol=1e-5, atol=1e-4)

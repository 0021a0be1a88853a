"""Kernel-function unit tests: analytic normalization + parity with the
reference formulas (/root/reference/src/fluid_compute.rs:55-63,
assets/simulation.wgsl:93-117)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from water_sandbox.core.params import KernelCoeffs
from water_sandbox.ops import kernels


H = 0.25


def coeffs(dim):
    return KernelCoeffs.from_radius(jnp.float32(H), dim)


def test_reference_normalization_values_3d():
    k = coeffs(3)
    pi = math.pi
    assert np.isclose(float(k.pow2), 15.0 / (2 * pi * H**5), rtol=1e-6)
    assert np.isclose(float(k.pow2_der), 15.0 / (pi * H**5), rtol=1e-6)
    assert np.isclose(float(k.pow3), 15.0 / (pi * H**6), rtol=1e-6)
    assert np.isclose(float(k.pow3_der), 45.0 / (pi * H**6), rtol=1e-6)
    assert np.isclose(float(k.spikey_pow3), 315.0 / (64 * pi * H**9), rtol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("which", ["density", "near", "viscosity"])
def test_kernels_integrate_to_one(dim, which):
    """∫ W dV over the support should be 1 (the point of normalization)."""
    k = coeffs(dim)
    r = np.linspace(0, H, 200001)
    fn = {"density": kernels.w_density, "near": kernels.w_near,
          "viscosity": kernels.w_viscosity}[which]
    w = np.asarray(fn(jnp.asarray(r, jnp.float32), jnp.float32(H), k),
                   np.float64)
    if dim == 2:
        integrand = w * 2 * math.pi * r
    else:
        integrand = w * 4 * math.pi * r**2
    total = np.trapezoid(integrand, r)
    assert np.isclose(total, 1.0, rtol=1e-3), total


def test_derivatives_match_finite_difference():
    k = coeffs(3)
    h = jnp.float32(H)
    d = jnp.asarray(np.linspace(0.01, H - 0.01, 50), jnp.float32)
    eps = 1e-4
    fd = (kernels.w_density(d + eps, h, k) - kernels.w_density(d - eps, h, k)
          ) / (2 * eps)
    np.testing.assert_allclose(np.asarray(fd),
                               np.asarray(kernels.dw_density(d, h, k)),
                               rtol=2e-2)
    # near-kernel derivative: reference drops the sign (dw_near >= 0);
    # magnitude should match |d/dd (h-d)^3 pow3|
    fd_near = (kernels.w_near(d + eps, h, k) - kernels.w_near(d - eps, h, k)
               ) / (2 * eps)
    np.testing.assert_allclose(np.abs(np.asarray(fd_near)),
                               np.asarray(kernels.dw_near(d, h, k)),
                               rtol=2e-2)


def test_support_mask_inclusive_boundary():
    assert bool(kernels.support_mask(jnp.float32(H), jnp.float32(H)))
    assert not bool(kernels.support_mask(jnp.float32(H + 1e-6), jnp.float32(H)))

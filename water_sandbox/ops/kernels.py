"""SPH smoothing-kernel functions (pure, elementwise).

Shapes mirror the WGSL kernel functions at
/root/reference/assets/simulation.wgsl:93-117; normalization constants come
from :class:`water_sandbox.core.params.KernelCoeffs`
(reference: /root/reference/src/fluid_compute.rs:55-63).

All functions take distances `d` (any shape) and return weights of the same
shape. They are *unmasked* — callers apply the `d <= h` support cutoff
(the reference skips `dst > h`, simulation.wgsl:154-157,238-241, so the
boundary d == h is *included*; its weight is 0 anyway except for poly6).
"""

from __future__ import annotations

import jax


from ..core.params import KernelCoeffs

Array = jax.Array


def w_density(d: Array, h: Array, k: KernelCoeffs) -> Array:
    """Spiky² density kernel: (h-d)² · pow2 (simulation.wgsl:93-96)."""
    v = h - d
    return v * v * k.pow2


def w_near(d: Array, h: Array, k: KernelCoeffs) -> Array:
    """Spiky³ near-density kernel: (h-d)³ · pow3 (simulation.wgsl:98-101)."""
    v = h - d
    return v * v * v * k.pow3


def dw_density(d: Array, h: Array, k: KernelCoeffs) -> Array:
    """Derivative of the density kernel: (d-h) · pow2_der
    (simulation.wgsl:105-107). Negative inside the support."""
    return (d - h) * k.pow2_der


def dw_near(d: Array, h: Array, k: KernelCoeffs) -> Array:
    """Derivative of the near kernel: (d-h)² · pow3_der
    (simulation.wgsl:109-112). NOTE: positive — faithful to the reference,
    which drops the sign when squaring."""
    v = d - h
    return v * v * k.pow3_der


def w_viscosity(d: Array, h: Array, k: KernelCoeffs) -> Array:
    """Poly6 kernel used for viscosity: (h²-d²)³ · spikey_pow3
    (simulation.wgsl:114-117)."""
    v = h * h - d * d
    return v * v * v * k.spikey_pow3


def support_mask(d: Array, h: Array) -> Array:
    """Inside-support mask; inclusive of d == h like the reference's
    `if dst > h { continue; }` (simulation.wgsl:154,238)."""
    return d <= h

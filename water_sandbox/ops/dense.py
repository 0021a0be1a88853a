"""Dense O(N²) all-pairs SPH passes — the correctness oracle.

Implements exactly the physics of the reference's ``update_density``
(/root/reference/assets/simulation.wgsl:144-195) and ``update_pressure_force``
(simulation.wgsl:198-269) passes, but over *all* pairs instead of the
hashed-cell walk. For true (collision-free) neighborhoods the two are
mathematically identical because the reference distance-filters every
candidate (simulation.wgsl:154,238).

To also emulate the reference's hash-collision *multi-count* semantics —
a pair is accumulated once per neighbor-cell offset whose hash collides with
the pair's cell hash (see SURVEY.md §7 hard part 3) — every pass accepts an
optional ``pair_weight`` (n, n) integer matrix produced by
``ops.hashing.reference_pair_weights``.

These functions are pure and jittable; use for n ≲ 16k (memory is O(N²)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.params import DENSITY_PADDING, KernelCoeffs, SimParams
from . import kernels

Array = jax.Array


def _pairwise_dist(predicted: Array):
    """Pairwise displacement d_ij = p_j - p_i and distances. (n,n,dim)/(n,n)."""
    disp = predicted[None, :, :] - predicted[:, None, :]
    dist = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
    return disp, dist


def density_pass(predicted: Array, params: SimParams, coeffs: KernelCoeffs,
                 pair_weight: Array | None = None):
    """Densities + equation of state (simulation.wgsl:144-195).

    Self-interaction is *included* (the reference's cell walk visits the
    particle itself). Returns (density, near_density, pressure, near_pressure).
    """
    h = params.smoothing_radius
    _, dist = _pairwise_dist(predicted)
    w = jnp.where(kernels.support_mask(dist, h),
                  kernels.w_density(dist, h, coeffs), 0.0)
    wn = jnp.where(kernels.support_mask(dist, h),
                   kernels.w_near(dist, h, coeffs), 0.0)
    if pair_weight is not None:
        w = w * pair_weight
        wn = wn * pair_weight
    density = jnp.sum(w, axis=1) + DENSITY_PADDING
    near_density = jnp.sum(wn, axis=1) + DENSITY_PADDING
    pressure = params.pressure_scalar * (density - params.target_density)
    near_pressure = params.near_pressure_scalar * near_density
    return density, near_density, pressure, near_pressure


def force_pass(predicted: Array, vel: Array, density: Array,
               near_density: Array, pressure: Array, near_pressure: Array,
               params: SimParams, coeffs: KernelCoeffs,
               pair_weight: Array | None = None) -> Array:
    """Pressure + near-pressure + viscosity acceleration
    (simulation.wgsl:198-269). Self pair is skipped (wgsl:231-233).

    Per neighbor j of i (d = |p_j - p_i| <= h):
        dir      = (p_j - p_i)/d, or +ŷ when d == 0 (wgsl:243-248)
        F_p     += dir · (p̄ · W'(d) / ρ_j  +  p̄_near · W'_near(d) / ρ_near_j)
        F_visc  += (v_j - v_i) · W_poly6(d)
        accel    = F_p / ρ_i + μ · F_visc
    """
    n, dim = predicted.shape
    h = params.smoothing_radius
    disp, dist = _pairwise_dist(predicted)

    eye = jnp.eye(n, dtype=bool)
    mask = kernels.support_mask(dist, h) & ~eye
    if pair_weight is not None:
        weight = jnp.where(mask, pair_weight.astype(predicted.dtype), 0.0)
    else:
        weight = mask.astype(predicted.dtype)

    # Direction with the reference's d == 0 fallback of +y (wgsl:243-248).
    up = jnp.zeros((dim,), predicted.dtype).at[1].set(1.0)
    safe = jnp.where(dist > 0.0, dist, 1.0)
    direction = jnp.where((dist > 0.0)[..., None], disp / safe[..., None], up)

    slope = kernels.dw_density(dist, h, coeffs)
    slope_near = kernels.dw_near(dist, h, coeffs)
    shared_p = (pressure[:, None] + pressure[None, :]) * 0.5
    shared_np = (near_pressure[:, None] + near_pressure[None, :]) * 0.5

    scale = weight * (shared_p * slope / density[None, :]
                      + shared_np * slope_near / near_density[None, :])
    pressure_force = jnp.sum(direction * scale[..., None], axis=1)

    w_visc = weight * kernels.w_viscosity(dist, h, coeffs)
    dvel = vel[None, :, :] - vel[:, None, :]
    viscosity_force = jnp.sum(dvel * w_visc[..., None], axis=1)

    return (pressure_force / density[:, None]
            + params.viscosity_strength * viscosity_force)


def _row_blocks(arrays, n: int, block: int):
    """Stack (n, ...) arrays into (n_pad // block, block, ...) query blocks.
    Padding rows copy row 0; their results are sliced off by the caller."""
    n_pad = -(-n // block) * block

    def pad(a):
        if n_pad == n:
            return a
        fill = jnp.broadcast_to(a[:1], (n_pad - n,) + a.shape[1:])
        return jnp.concatenate([a, fill], axis=0)

    return tuple(pad(a).reshape((n_pad // block, block) + a.shape[1:])
                 for a in arrays)


def _unblock(out, n: int):
    return jax.tree.map(lambda o: o.reshape((-1,) + o.shape[2:])[:n], out)


def density_pass_blocked(predicted: Array, params: SimParams,
                         coeffs: KernelCoeffs, block: int = 256):
    """:func:`density_pass` with the query rows taken ``block`` at a time
    (``lax.map``) against all particles: O(block · n) memory instead of
    O(n²), so the oracle reaches full scene widths (65k–266k particles)."""
    n = predicted.shape[0]
    h = params.smoothing_radius

    def rows(q):
        disp = predicted[None, :, :] - q[:, None, :]
        dist = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
        inside = kernels.support_mask(dist, h)
        w = jnp.where(inside, kernels.w_density(dist, h, coeffs), 0.0)
        wn = jnp.where(inside, kernels.w_near(dist, h, coeffs), 0.0)
        return jnp.sum(w, axis=1), jnp.sum(wn, axis=1)

    (q,) = _row_blocks((predicted,), n, block)
    density, near_density = _unblock(jax.lax.map(rows, q), n)
    density = density + DENSITY_PADDING
    near_density = near_density + DENSITY_PADDING
    pressure = params.pressure_scalar * (density - params.target_density)
    near_pressure = params.near_pressure_scalar * near_density
    return density, near_density, pressure, near_pressure


def force_pass_blocked(predicted: Array, vel: Array, density: Array,
                       near_density: Array, pressure: Array,
                       near_pressure: Array, params: SimParams,
                       coeffs: KernelCoeffs, block: int = 256) -> Array:
    """:func:`force_pass` with the query rows taken ``block`` at a time
    against all particles (see :func:`density_pass_blocked`)."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    up = jnp.zeros((dim,), predicted.dtype).at[1].set(1.0)
    ids = jnp.arange(n, dtype=jnp.int32)

    def rows(args):
        q_pos, q_vel, q_den, q_prs, q_nprs, q_id = args
        disp = predicted[None, :, :] - q_pos[:, None, :]
        dist = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
        mask = kernels.support_mask(dist, h) & (q_id[:, None] != ids[None, :])
        weight = mask.astype(predicted.dtype)
        safe = jnp.where(dist > 0.0, dist, 1.0)
        direction = jnp.where((dist > 0.0)[..., None],
                              disp / safe[..., None], up)
        slope = kernels.dw_density(dist, h, coeffs)
        slope_near = kernels.dw_near(dist, h, coeffs)
        shared_p = (q_prs[:, None] + pressure[None, :]) * 0.5
        shared_np = (q_nprs[:, None] + near_pressure[None, :]) * 0.5
        scale = weight * (shared_p * slope / density[None, :]
                          + shared_np * slope_near / near_density[None, :])
        pressure_force = jnp.sum(direction * scale[..., None], axis=1)
        w_visc = weight * kernels.w_viscosity(dist, h, coeffs)
        dvel = vel[None, :, :] - q_vel[:, None, :]
        viscosity_force = jnp.sum(dvel * w_visc[..., None], axis=1)
        return (pressure_force / q_den[:, None]
                + params.viscosity_strength * viscosity_force)

    blocks = _row_blocks((predicted, vel, density, pressure, near_pressure,
                          ids), n, block)
    return _unblock(jax.lax.map(rows, blocks), n)

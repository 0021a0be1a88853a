"""Exact rescue pass for cell-capacity overflow.

Fixed-capacity cell buckets drop particles beyond ``cell_capacity`` from the
neighbor structure. Dropping them from *physics* is not acceptable: this
module gives every dropped particle exact SPH physics via
a chunked dense sweep against ALL particles, and — just as important —
injects the dropped particles' contributions back into the resident
particles' densities and forces, so the result matches the dense oracle
bit-for-tolerance everywhere.

Exactness argument: bucket passes compute all resident↔resident pairs.
Every pair involving a dropped particle (dropped↔resident and
dropped↔dropped, self included for density per the reference walk,
simulation.wgsl:162-183) is computed here, once. Densities are corrected
*before* the force pass runs (pressure is a nonlinear function of density,
so force corrections cannot be patched post-hoc) — callers scatter the
corrected densities back into the cell planes and only then run the force
pass, then add the pair-force corrections from this module.

Budget: ``SimConfig.rescue_capacity`` (static) bounds the number of rescued
particles per step; overflow beyond it stays dropped and loudly counted.
Cost is O(rescue_capacity · n), paid only on steps where overflow occurs
(callers gate on ``overflow > 0`` with ``lax.cond``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from . import kernels

Array = jax.Array
_FAR = 1.0e15


def dropped_selection(dropped: Array, cap: int):
    """First `cap` dropped indices (stable order) and their validity.

    Returns (order (cap,) int32, valid (cap,) bool, rescued (n,) bool,
    unrescued () int32 — dropped beyond the budget)."""
    n = dropped.shape[0]
    prio = jnp.where(dropped, 0, 1).astype(jnp.int32)
    order = jnp.argsort(prio, stable=True)[:cap].astype(jnp.int32)
    valid = jnp.take(dropped, order)
    rescued = jnp.zeros((n,), bool).at[order].set(valid, mode="drop")
    unrescued = (jnp.sum(dropped) - jnp.sum(valid)).astype(jnp.int32)
    return order, valid, rescued, unrescued


def _pad_chunks(arr: Array, chunk: int, fill) -> Array:
    n = arr.shape[0]
    n_pad = -(-n // chunk) * chunk
    if n_pad != n:
        block = jnp.full((n_pad - n,) + arr.shape[1:], fill, arr.dtype)
        arr = jnp.concatenate([arr, block], axis=0)
    return arr.reshape((n_pad // chunk, chunk) + arr.shape[1:])


def density_rescue(predicted: Array, dropped: Array, den: Array, nden: Array,
                   params: SimParams, coeffs: KernelCoeffs, cfg: SimConfig,
                   budget: int | None = None):
    """Exact densities with dropped particles included.

    ``den``/``nden`` are the bucket results (dropped rows hold fill values).
    ``budget`` overrides cfg.rescue_capacity (callers use a small-budget
    tier for the common tiny-overflow case — sweep cost is O(budget · n)).
    Returns (den, nden, rescued (n,) bool, unrescued () int32)."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    O = min(budget or cfg.rescue_capacity, n)
    order, valid, rescued, unrescued = dropped_selection(dropped, O)
    opos = jnp.where(valid[:, None], jnp.take(predicted, order, axis=0),
                     _FAR)

    chunks = _pad_chunks(predicted, cfg.chunk, _FAR)

    def body(carry, cpos):
        den_o, nden_o = carry
        d2 = jnp.sum((opos[:, None, :] - cpos[None, :, :]) ** 2, axis=-1)
        dist = jnp.sqrt(jnp.minimum(d2, jnp.asarray(_FAR, d2.dtype)))
        m = jnp.where(dist <= h, 1.0, 0.0)
        dc = jnp.minimum(dist, h)
        w = m * kernels.w_density(dc, h, coeffs)
        wn = m * kernels.w_near(dc, h, coeffs)
        # o-side: sum over ALL particles (self included, wgsl:162-183)
        den_o = den_o + jnp.sum(w, axis=1)
        nden_o = nden_o + jnp.sum(wn, axis=1)
        # chunk-side: contributions of the dropped set to these particles
        return (den_o, nden_o), (jnp.sum(w, axis=0), jnp.sum(wn, axis=0))

    (den_o, nden_o), (cw, cwn) = jax.lax.scan(
        body, (jnp.zeros((O,), den.dtype), jnp.zeros((O,), den.dtype)),
        chunks)
    contrib_w = cw.reshape(-1)[:n]
    contrib_wn = cwn.reshape(-1)[:n]
    den_o = den_o + DENSITY_PADDING
    nden_o = nden_o + DENSITY_PADDING

    # residents gain the dropped contributions; rescued rows are replaced
    # by their exact dense sums (which already count every pair once)
    den_full = jnp.zeros_like(den).at[order].set(
        jnp.where(valid, den_o, 0.0), mode="drop")
    nden_full = jnp.zeros_like(nden).at[order].set(
        jnp.where(valid, nden_o, 0.0), mode="drop")
    # dropped-but-unrescued rows (budget exceeded) keep their fill values —
    # still out of the physics, still counted in `unrescued`
    den = jnp.where(rescued, den_full,
                    jnp.where(dropped, den, den + contrib_w))
    nden = jnp.where(rescued, nden_full,
                     jnp.where(dropped, nden, nden + contrib_wn))
    return den, nden, rescued, unrescued


def force_rescue(predicted: Array, vel: Array, den: Array, nden: Array,
                 prs: Array, nprs: Array, dropped: Array, acc: Array,
                 params: SimParams, coeffs: KernelCoeffs, cfg: SimConfig,
                 budget: int | None = None):
    """Exact accelerations: every pair involving a dropped particle is
    evaluated here (simulation.wgsl:198-269 formulas), the pair's
    contribution added to both sides. ``acc`` is the bucket force result
    computed with the CORRECTED densities (rescued rows hold zero)."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    O = min(budget or cfg.rescue_capacity, n)
    order, valid, rescued, _ = dropped_selection(dropped, O)
    # beyond-budget (dropped-but-unrescued) particles carry FILL densities
    # (near_density = 1e-5): a pair force divided by them amplifies ~1e5x
    # and detonates the simulation the first time overflow exceeds the
    # budget. Those particles are out of the physics this step by contract —
    # exclude every pair that touches them (they are loudly counted).
    unres = dropped & ~rescued

    def take_o(a, fill):
        rows = jnp.take(a, order, axis=0)
        sel = valid.reshape((-1,) + (1,) * (a.ndim - 1))
        return jnp.where(sel, rows, fill)

    opos = take_o(predicted, _FAR)
    ovel = take_o(vel, 0.0)
    oden = take_o(den, 1.0)
    onden = take_o(nden, 1.0)
    oprs = take_o(prs, 0.0)
    onprs = take_o(nprs, 0.0)
    oid = jnp.where(valid, order, -1)

    iota = jnp.arange(n, dtype=jnp.int32)
    iota = jnp.where(unres, -3, iota)  # excluded via the id mask below
    chunks_pos = _pad_chunks(predicted, cfg.chunk, _FAR)
    chunks_vel = _pad_chunks(vel, cfg.chunk, 0.0)
    chunks_den = _pad_chunks(den, cfg.chunk, 1.0)
    chunks_nden = _pad_chunks(nden, cfg.chunk, 1.0)
    chunks_prs = _pad_chunks(prs, cfg.chunk, 0.0)
    chunks_nprs = _pad_chunks(nprs, cfg.chunk, 0.0)
    chunks_id = _pad_chunks(iota, cfg.chunk, -2)

    up = jnp.zeros((dim,), predicted.dtype).at[1].set(1.0)

    def body(carry, chunk):
        pf_o, vf_o = carry
        cpos, cvel, cden, cnden, cprs, cnprs, cid = chunk
        disp = cpos[None, :, :] - opos[:, None, :]       # o -> j
        d2 = jnp.sum(disp * disp, axis=-1)
        dist = jnp.sqrt(jnp.minimum(d2, jnp.asarray(_FAR, d2.dtype)))
        m = jnp.where((dist <= h) & (oid[:, None] != cid[None, :])
                      & (cid[None, :] != -3), 1.0, 0.0)
        dc = jnp.minimum(dist, h)
        safe = jnp.where(dist > 0.0, dist, 1.0)
        dir_oj = jnp.where((dist > 0.0)[..., None], disp / safe[..., None],
                           up)                            # o's view
        shared_p = (oprs[:, None] + cprs[None, :]) * 0.5
        shared_np = (onprs[:, None] + cnprs[None, :]) * 0.5
        dw = kernels.dw_density(dc, h, coeffs)
        dwn = kernels.dw_near(dc, h, coeffs)
        wv = m * kernels.w_viscosity(dc, h, coeffs)

        # force ON o from j: divide by neighbor (j) densities
        scale_o = m * (shared_p * dw / cden[None, :]
                       + shared_np * dwn / cnden[None, :])
        pf_o = pf_o + jnp.sum(dir_oj * scale_o[..., None], axis=1)
        vf_o = vf_o + jnp.sum((cvel[None, :, :] - ovel[:, None, :])
                              * wv[..., None], axis=1)

        # force ON j from o: direction flips, divide by o's densities.
        # NOTE dir asymmetry at dist == 0: BOTH sides use +y (wgsl:243-248),
        # it does not flip — matches the reference's per-thread view.
        dir_jo = jnp.where((dist > 0.0)[..., None], -dir_oj, up)
        scale_j = m * (shared_p * dw / oden[:, None]
                       + shared_np * dwn / onden[:, None])
        pf_j = jnp.sum(dir_jo * scale_j[..., None], axis=0)   # (C, dim)
        vf_j = jnp.sum((ovel[:, None, :] - cvel[None, :, :])
                       * wv[..., None], axis=0)
        return (pf_o, vf_o), (pf_j, vf_j)

    zero_o = jnp.zeros((O, dim), acc.dtype)
    (pf_o, vf_o), (pf_j, vf_j) = jax.lax.scan(
        body, (zero_o, zero_o),
        (chunks_pos, chunks_vel, chunks_den, chunks_nden, chunks_prs,
         chunks_nprs, chunks_id))
    pf_j = pf_j.reshape(-1, dim)[:n]
    vf_j = vf_j.reshape(-1, dim)[:n]

    acc_o = pf_o / jnp.where(valid, oden, 1.0)[:, None] \
        + params.viscosity_strength * vf_o
    acc_o_full = jnp.zeros_like(acc).at[order].set(
        jnp.where(valid[:, None], acc_o, 0.0), mode="drop")
    acc_corr = pf_j / den[:, None] + params.viscosity_strength * vf_j
    return jnp.where(rescued[:, None], acc_o_full,
                     jnp.where(dropped[:, None], acc, acc + acc_corr))


def small_budget(cfg: SimConfig) -> int:
    """The cheap-tier budget: steady-state overflow is typically a handful
    of particles at a container corner; sweeping the full rescue budget for
    them costs seconds per step at 256k. Callers lax.cond between this tier
    and the full budget on the actual overflow count."""
    return min(256, cfg.rescue_capacity)

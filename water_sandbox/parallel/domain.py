"""Explicit spatial domain decomposition — shard_map + ppermute halo exchange.

The hand-scheduled counterpart of parallel/gspmd.py (SURVEY.md §5's
"ring-communication analogue": each shard exchanges one-slab boundary cell
planes with its mesh neighbors, like ring attention exchanges KV
blocks). The reference has no multi-device story at all (single GPU,
SURVEY.md §2); this module is the scaling layer designed for it.

Scheme (1-D mesh over the container's x axis):

* Every device owns a fixed-capacity slice of the particle arrays
  (n_global = ndev · P slots, row-sharded; inactive slots masked). Ownership
  is by cell-x slab: device d owns cells [d·gx_loc, (d+1)·gx_loc).
* Per step, each device buckets its *local* particles into its slab range of
  the global bounded grid (grid anchored to the container — a deterministic
  anchor all devices agree on, unlike the single-chip dynamic anchor).
* Halo exchange: the boundary x-slab bucket planes (positions+mask, then
  density fields) travel to mesh neighbors via two `lax.ppermute`s (left and
  right). Density is computed for local+halo slabs, forces for local slabs
  only — so each pair is computed by its owner with exact neighbor data.
* Migration: after integration, particles whose new cell-x lies outside the
  local slab are packed into fixed-capacity send buffers, ppermuted to the
  neighbor, and merged into free slots (fluids move ≤ one slab per step for
  any sane dt; violations are counted, not lost silently — they stay local
  and re-migrate next step).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from ..core.state import FluidState
from ..ops import grid as grid_mod, integrate as integrate_mod
from ..ops.grid import _FAR

Array = jax.Array


def _grid_origin_static(params: SimParams, cfg: SimConfig) -> Array:
    """Deterministic grid anchor shared by all devices: one cell below the
    container's minimum corner (padded for the prediction lookahead)."""
    h = params.smoothing_radius
    c = params.container
    return c.center - c.half_size - 2.0 * h


def shard_state(state: FluidState, mesh: Mesh, cfg: SimConfig,
                params: SimParams, slack: float = 2.0):
    """Re-pack a dense state into fixed-capacity per-device slabs.

    Returns (padded FluidState with n = ndev·P, active mask (ndev·P,)).
    Particles are assigned to devices by cell-x slab so locality holds from
    step one."""
    ndev = mesh.devices.size
    n = state.n
    gx = cfg.grid_dims[0]
    assert gx % ndev == 0, "grid_dims[0] must divide by mesh size"
    gx_loc = gx // ndev
    P_cap = int(-(-n // ndev) * slack)

    origin = _grid_origin_static(params, cfg)
    cell = jnp.floor((state.predicted - origin) / params.smoothing_radius)
    owner = jnp.clip(cell[:, 0].astype(jnp.int32) // gx_loc, 0, ndev - 1)

    # host-side packing (init-time only)
    import numpy as np
    owner_np = np.asarray(owner)
    idx_by_dev = [np.where(owner_np == d)[0] for d in range(ndev)]
    for d, idx in enumerate(idx_by_dev):
        if len(idx) > P_cap:
            raise ValueError(
                f"device {d} gets {len(idx)} particles > capacity {P_cap}; "
                "raise slack")

    def pack(arr, fill):
        arr_np = np.asarray(arr)
        out = np.full((ndev * P_cap,) + arr_np.shape[1:], fill, arr_np.dtype)
        for d, idx in enumerate(idx_by_dev):
            out[d * P_cap:d * P_cap + len(idx)] = arr_np[idx]
        return jnp.asarray(out)

    active = np.zeros((ndev * P_cap,), np.float32)
    for d, idx in enumerate(idx_by_dev):
        active[d * P_cap:d * P_cap + len(idx)] = 1.0

    packed = FluidState(
        pos=pack(state.pos, _FAR),
        vel=pack(state.vel, 0.0),
        predicted=pack(state.predicted, _FAR),
        acc=pack(state.acc, 0.0),
        density=pack(state.density, 0.0),
        near_density=pack(state.near_density, 0.0),
        pressure=pack(state.pressure, 0.0),
        near_pressure=pack(state.near_pressure, 0.0),
        step_count=state.step_count,
        time=state.time,
        overflow=state.overflow,
        overflow_total=state.overflow_total,
        ids=pack(state.ids, -1),
    )
    axis = mesh.axis_names[0]

    def place(x):
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(
            x, NamedSharding(mesh, P(*([axis] + [None] * (x.ndim - 1)))))

    return jax.tree.map(place, packed), place(jnp.asarray(active))


def _local_buckets(pred, vel, active, origin, params, cfg, gx_loc, my_dev):
    """Bucket local particles into the local slab range (+ nothing else).
    Particles currently outside the local slab (pre-migration stragglers)
    are clamped into the boundary slab with their positions untouched, so
    every pair the walk *does* visit uses exact geometry — but a straggler
    only sees pairs inside the local+halo window; true neighbors deeper in
    the neighboring domain are missed until it migrates (bounded error:
    fluids move ≤ one slab per step for sane dt, and send overflow that
    delays migration is counted in `lost`)."""
    h = params.smoothing_radius
    dims = cfg.grid_dims
    S = 1
    for d in dims[1:]:
        S *= d
    nc_loc = gx_loc * S
    cap = cfg.cell_capacity
    Pn, dim = pred.shape

    cell = jnp.floor((pred - origin) / h).astype(jnp.int32)
    dims_arr = jnp.asarray(dims, jnp.int32)
    cell = jnp.clip(cell, 0, dims_arr - 1)
    cx_local = jnp.clip(cell[:, 0] - my_dev * gx_loc, 0, gx_loc - 1)
    rest = cell[:, 1]
    for a in range(2, len(dims)):
        rest = rest * dims[a] + cell[:, a]
    cid = cx_local * S + rest
    # inactive slots go to the drop address
    order = jnp.argsort(jnp.where(active > 0, cid, nc_loc)).astype(jnp.int32)
    sorted_cid = jnp.take(cid, order)
    sorted_active = jnp.take(active, order)
    ranks = jnp.arange(Pn, dtype=jnp.int32)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cid[1:] != sorted_cid[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, ranks, 0))
    slot = ranks - run_start
    ok = (slot < cap) & (sorted_active > 0)
    flat = jnp.where(ok, slot * nc_loc + sorted_cid, cap * nc_loc)

    def scatter(vals, fill):
        out = jnp.full((cap * nc_loc + 1,), fill, pred.dtype)
        return out.at[flat].set(vals, mode="drop",
                                unique_indices=True)[:-1].reshape(cap, nc_loc)

    cell_pos = jnp.stack([scatter(jnp.take(pred[:, a], order), _FAR)
                          for a in range(dim)])
    cell_vel = jnp.stack([scatter(jnp.take(vel[:, a], order), 0.0)
                          for a in range(dim)])
    cell_mask = scatter(jnp.ones((Pn,), pred.dtype), 0.0)
    addr = jnp.zeros((Pn,), jnp.int32).at[order].set(flat,
                                                     unique_indices=True)
    overflow = (jnp.sum(active) - jnp.sum(cell_mask)).astype(jnp.int32)
    return cell_pos, cell_vel, cell_mask, addr, overflow, S


def _exchange_halo(planes: Array, S: int, axis: str) -> Array:
    """Append neighbor boundary slabs: left neighbor's last slab in front,
    right neighbor's first slab behind. planes: (F, C, gx_loc·S) →
    (F, C, (gx_loc+2)·S). Edge devices receive zero-mask slabs."""
    ndev = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    last = planes[..., -S:]
    first = planes[..., :S]
    # send my last slab rightward → arrives as left halo of my right neighbor
    from_left = jax.lax.ppermute(
        last, axis, [(d, (d + 1) % ndev) for d in range(ndev)])
    # send my first slab leftward → arrives as right halo of my left neighbor
    from_right = jax.lax.ppermute(
        first, axis, [(d, (d - 1) % ndev) for d in range(ndev)])
    # zero the wrapped edges (device 0 has no left neighbor, etc.)
    from_left = jnp.where(me == 0, jnp.zeros_like(from_left), from_left)
    from_right = jnp.where(me == ndev - 1, jnp.zeros_like(from_right),
                           from_right)
    return jnp.concatenate([from_left, planes, from_right], axis=-1)


def _sph_local(pred, vel, active, params, coeffs, cfg, gx_loc, axis,
               rescue_cap=256):
    """Density + force for local particles with halo-correct neighbor data.

    With cfg.rescue_capacity > 0, capacity-overflow particles get the EXACT
    rescue (same contract as the single-device path, ops/rescue.py) — up to
    `rescue_cap` per device per step, with dropped rows ppermuted to both
    neighbors so cross-device pairs are exact too. The rescue runs under a
    pmax(overflow) > 0 cond: overflow-free steps pay one collective."""
    me = jax.lax.axis_index(axis)
    origin = _grid_origin_static(params, cfg)
    cell_pos, cell_vel, cell_mask, addr, overflow, S = _local_buckets(
        pred, vel, active, origin, params, cfg, gx_loc, me)

    # extended planes: local + one halo slab each side
    ext_dims = (gx_loc + 2,) + cfg.grid_dims[1:]
    ext_cfg = dataclasses.replace(cfg, grid_dims=ext_dims)
    nc_loc = gx_loc * S
    dim = cfg.dim
    cap = cfg.cell_capacity
    Pn = pred.shape[0]

    pm = jnp.concatenate([cell_pos, cell_mask[None]], axis=0)
    pm_ext = _exchange_halo(pm, S, axis)
    grid_ext = grid_mod.BucketGrid(
        cell_pos=pm_ext[:dim], cell_vel=None, cell_mask=pm_ext[dim],
        addr=None, origin=origin, overflow=overflow)
    den_e, nden_e, prs_e, nprs_e = grid_mod.bucket_density_pass(
        grid_ext, params, coeffs, ext_cfg)

    # only the middle (local) slabs' densities are correct — the halo slabs
    # lack their own outer neighbors. Slice local, then exchange the
    # *computed* density planes so the force pass sees exact halo densities.
    den_c = den_e[:, S:S + nc_loc]
    nden_c = nden_e[:, S:S + nc_loc]

    dropped = (addr == cap * nc_loc) & (active > 0)
    rescue_on = cfg.rescue_capacity > 0
    R = min(rescue_cap, cfg.rescue_capacity or 1, Pn)
    ovf_any = jax.lax.pmax(overflow, axis) > 0

    def halo_pos():
        hp = jnp.concatenate([pm_ext[:dim, :, :S], pm_ext[:dim, :, -S:]],
                             axis=-1)
        return hp.reshape(dim, -1).T  # (2*cap*S, dim)

    if rescue_on:
        def ph1(den_c, nden_c):
            den_p = grid_mod._from_cells(den_c, addr,
                                         params.target_density)
            nden_p = grid_mod._from_cells(nden_c, addr, DENSITY_PADDING)
            den_p, nden_p, odata, rescued, unres = _rescue_density_common(
                pred, vel, active, dropped, den_p, nden_p, halo_pos(),
                params, coeffs, R, axis, cfg.chunk)
            den_c = den_c.reshape(-1).at[addr].set(
                den_p, mode="drop").reshape(cap, nc_loc)
            nden_c = nden_c.reshape(-1).at[addr].set(
                nden_p, mode="drop").reshape(cap, nc_loc)
            return den_c, nden_c, odata, rescued, den_p, nden_p, unres

        def ph1_skip(den_c, nden_c):
            odata = {"order": jnp.zeros((R,), jnp.int32),
                     "valid": jnp.zeros((R,), bool),
                     "pos": jnp.full((R, dim), _FAR, pred.dtype),
                     "vel": jnp.zeros((R, dim), pred.dtype),
                     "den": jnp.zeros((R,), pred.dtype),
                     "nden": jnp.zeros((R,), pred.dtype)}
            zeros = jnp.zeros((Pn,), pred.dtype)
            return (den_c, nden_c, odata, jnp.zeros((Pn,), bool), zeros,
                    zeros, overflow)

        den_c, nden_c, odata, rescued, den_r, nden_r, unres = jax.lax.cond(
            ovf_any, ph1, ph1_skip, den_c, nden_c)
    else:
        unres = overflow

    prs_c = params.pressure_scalar * (den_c - params.target_density)
    nprs_c = params.near_pressure_scalar * nden_c
    dfields = jnp.stack([den_c, nden_c, prs_c, nprs_c], axis=0)
    dfields_e = _exchange_halo(dfields, S, axis)
    # guard the halo divide: zero-mask halo slots carry density 0 on edge
    # devices (bucket_force_pass already guards, but keep them positive)
    den_x, nden_x, prs_x, nprs_x = (dfields_e[0], dfields_e[1],
                                    dfields_e[2], dfields_e[3])

    # force pass over the extended window, with halo velocities + densities
    v_ext = _exchange_halo(cell_vel, S, axis)
    grid_f = grid_mod.BucketGrid(
        cell_pos=pm_ext[:dim], cell_vel=v_ext, cell_mask=pm_ext[dim],
        addr=None, origin=origin, overflow=overflow)
    acc_e = grid_mod.bucket_force_pass(grid_f, den_x, nden_x, prs_x, nprs_x,
                                       params, coeffs, ext_cfg)
    acc_c = acc_e[:, :, S:S + nc_loc]

    den = grid_mod._from_cells(den_c, addr, params.target_density)
    nden = grid_mod._from_cells(nden_c, addr, DENSITY_PADDING)
    acc = grid_mod._from_cells(acc_c, addr, 0.0)

    if rescue_on:
        den = jnp.where(rescued, den_r, den)
        nden = jnp.where(rescued, nden_r, nden)

        def ph2(acc):
            hvel = jnp.concatenate([v_ext[:, :, :S], v_ext[:, :, -S:]],
                                   axis=-1).reshape(dim, -1).T
            hde = jnp.concatenate(
                [dfields_e[:2, :, :S], dfields_e[:2, :, -S:]],
                axis=-1).reshape(2, -1)
            halo = {"pos": halo_pos(), "vel": hvel,
                    "den": hde[0], "nden": hde[1]}
            return _rescue_force_common(
                acc, pred, vel, active, dropped, den, nden, odata, rescued,
                halo, params, coeffs, axis, cfg.chunk)

        acc = jax.lax.cond(ovf_any, ph2, lambda a: a, acc)

    prs = params.pressure_scalar * (den - params.target_density)
    nprs = params.near_pressure_scalar * nden
    return den, nden, prs, nprs, acc, unres


# --------------------------------------------------------------------------
# exact capacity-overflow rescue, domain-decomposed
# --------------------------------------------------------------------------
#
# The single-chip contract (ops/rescue.py): NO particle is ever silently
# dropped from the physics — cell-capacity overflow gets a dense sweep and
# its pair contributions are injected back on both sides. Multi-chip, a
# dropped particle's neighbors can live on the adjacent device, and a local
# particle's density can depend on a NEIGHBOR's dropped particle. Scheme:
#
# 1. each device packs up to R dropped rows (pos, vel) and ppermutes them to
#    both mesh neighbors;
# 2. density rescue: one sweep of [mine + from-left + from-right] dropped
#    queries against the LOCAL particle array (query-side sums for my rows,
#    candidate-side corrections for local residents), plus a second sweep of
#    my dropped rows against the halo-slab pseudo-particles (the exchanged
#    boundary bucket planes) — together covering every pair a dropped
#    particle has within the local + one-slab-halo window. Corrected
#    densities are scattered back into the planes BEFORE the density
#    exchange, so neighbors' force passes see them;
# 3. the dropped rows' corrected (den, nden) are ppermuted to the neighbors;
# 4. force rescue mirrors (2) with the pair-force formulas, adding
#    corrections to my residents from mine + the neighbors' dropped rows.
#
# Beyond-budget overflow stays dropped and loudly counted (psum'd), exactly
# like the single-chip budget tier. Like the straggler bound, a dropped
# particle at the far edge of the halo window misses neighbors deeper than
# one slab — the same one-slab locality assumption the whole domain step
# rests on (fluids move ≤ one slab per step; migration runs every step).

def _pack_dropped(pred, vel, dropped, R):
    """First R dropped rows (stable order): local indices, validity, and
    _FAR-padded feature rows."""
    prio = jnp.where(dropped, 0, 1).astype(jnp.int32)
    order = jnp.argsort(prio, stable=True)[:R].astype(jnp.int32)
    valid = jnp.take(dropped, order)
    opos = jnp.where(valid[:, None], jnp.take(pred, order, axis=0), _FAR)
    ovel = jnp.where(valid[:, None], jnp.take(vel, order, axis=0), 0.0)
    return order, valid, opos, ovel


def _both_ways(tree, axis):
    """ppermute a pytree to the right and to the left neighbor; wrapped
    edges are invalidated by callers via the 'valid' leaf."""
    ndev = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    from_left = jax.tree.map(lambda x: jax.lax.ppermute(
        x, axis, [(d, (d + 1) % ndev) for d in range(ndev)]), tree)
    from_right = jax.tree.map(lambda x: jax.lax.ppermute(
        x, axis, [(d, (d - 1) % ndev) for d in range(ndev)]), tree)
    from_left["valid"] = jnp.where(me == 0, False, from_left["valid"])
    from_right["valid"] = jnp.where(me == ndev - 1, False,
                                    from_right["valid"])
    return from_left, from_right


def _pad_chunks_arr(arr, chunk, fill):
    n = arr.shape[0]
    n_pad = -(-n // chunk) * chunk
    if n_pad != n:
        block = jnp.full((n_pad - n,) + arr.shape[1:], fill, arr.dtype)
        arr = jnp.concatenate([arr, block], axis=0)
    return arr.reshape((n_pad // chunk, chunk) + arr.shape[1:])


def _density_sweep(opos, cand_groups, params, coeffs, chunk,
                   want_corrections=False):
    """Chunked dense density sweep: queries (O, dim) vs each candidate
    group {'pos': (C, dim)}. Returns query-side (den_o, nden_o) sums and —
    for the FIRST group only, when asked — per-candidate corrections
    (contributions of all queries to that candidate)."""
    from ..ops import kernels
    h = params.smoothing_radius
    O = opos.shape[0]
    dt = opos.dtype
    den_o = jnp.zeros((O,), dt)
    nden_o = jnp.zeros((O,), dt)
    corrections = None
    for gi, grp in enumerate(cand_groups):
        cpos_all = grp["pos"]
        nC = cpos_all.shape[0]
        chunks = _pad_chunks_arr(cpos_all, chunk, _FAR)

        def body(carry, cpos):
            d_o, nd_o = carry
            d2 = jnp.sum((opos[:, None, :] - cpos[None, :, :]) ** 2, -1)
            dist = jnp.sqrt(jnp.minimum(d2, jnp.asarray(_FAR, dt)))
            m = jnp.where(dist <= h, 1.0, 0.0)
            dc = jnp.minimum(dist, h)
            w = m * kernels.w_density(dc, h, coeffs)
            wn = m * kernels.w_near(dc, h, coeffs)
            return ((d_o + jnp.sum(w, 1), nd_o + jnp.sum(wn, 1)),
                    (jnp.sum(w, 0), jnp.sum(wn, 0)))

        (den_o, nden_o), (cw, cwn) = jax.lax.scan(
            body, (den_o, nden_o), chunks)
        if gi == 0 and want_corrections:
            corrections = (cw.reshape(-1)[:nC], cwn.reshape(-1)[:nC])
    return den_o, nden_o, corrections


def _force_sweep(q, cand_groups, params, coeffs, chunk,
                 want_corrections=False):
    """Chunked dense pair-force sweep (simulation.wgsl:198-269 formulas,
    mirroring ops/rescue.py::force_rescue). q: dict of query rows (pos, vel,
    den, nden, prs, nprs, id). Candidate groups: dicts with the same
    per-row features plus id (id -2 = padding, -3 = excluded beyond-budget
    rows). Returns query-side (pf_o, vf_o) and, for the first group when
    asked, per-candidate (pf_j, vf_j) corrections."""
    from ..ops import kernels
    h = params.smoothing_radius
    O, dim = q["pos"].shape
    dt = q["pos"].dtype
    up = jnp.zeros((dim,), dt).at[1].set(1.0)
    pf_o = jnp.zeros((O, dim), dt)
    vf_o = jnp.zeros((O, dim), dt)
    corrections = None
    for gi, grp in enumerate(cand_groups):
        nC = grp["pos"].shape[0]
        fills = dict(pos=_FAR, vel=0.0, den=1.0, nden=1.0, prs=0.0,
                     nprs=0.0, id=-2)
        chunks = {k: _pad_chunks_arr(grp[k], chunk, fills[k]) for k in grp}

        def body(carry, ch):
            pf, vf = carry
            disp = ch["pos"][None, :, :] - q["pos"][:, None, :]   # o -> j
            d2 = jnp.sum(disp * disp, axis=-1)
            dist = jnp.sqrt(jnp.minimum(d2, jnp.asarray(_FAR, dt)))
            m = jnp.where((dist <= h) & (q["id"][:, None] != ch["id"][None])
                          & (ch["id"][None] != -3), 1.0, 0.0)
            dc = jnp.minimum(dist, h)
            safe = jnp.where(dist > 0.0, dist, 1.0)
            dir_oj = jnp.where((dist > 0.0)[..., None],
                               disp / safe[..., None], up)
            shared_p = (q["prs"][:, None] + ch["prs"][None]) * 0.5
            shared_np = (q["nprs"][:, None] + ch["nprs"][None]) * 0.5
            dw = kernels.dw_density(dc, h, coeffs)
            dwn = kernels.dw_near(dc, h, coeffs)
            wv = m * kernels.w_viscosity(dc, h, coeffs)

            scale_o = m * (shared_p * dw / ch["den"][None]
                           + shared_np * dwn / ch["nden"][None])
            pf = pf + jnp.sum(dir_oj * scale_o[..., None], axis=1)
            vf = vf + jnp.sum((ch["vel"][None] - q["vel"][:, None])
                              * wv[..., None], axis=1)

            # force ON the candidate from the queries; both sides use +y at
            # dist == 0, faithful to the reference's per-thread view
            # (wgsl:243-248; ops/rescue.py:186-188)
            dir_jo = jnp.where((dist > 0.0)[..., None], -dir_oj, up)
            scale_j = m * (shared_p * dw / q["den"][:, None]
                           + shared_np * dwn / q["nden"][:, None])
            pf_j = jnp.sum(dir_jo * scale_j[..., None], axis=0)
            vf_j = jnp.sum((q["vel"][:, None] - ch["vel"][None])
                           * wv[..., None], axis=0)
            return (pf, vf), (pf_j, vf_j)

        (pf_o, vf_o), (pf_j, vf_j) = jax.lax.scan(body, (pf_o, vf_o), chunks)
        if gi == 0 and want_corrections:
            corrections = (pf_j.reshape(-1, dim)[:nC],
                           vf_j.reshape(-1, dim)[:nC])
    return pf_o, vf_o, corrections


def _rescue_density_common(pred, vel, active, dropped, den_p, nden_p,
                           halo_pos, params, coeffs, R, axis, chunk):
    """Phase-1 rescue (path-independent core): pack + exchange dropped rows,
    sweep [mine + neighbors'] against locals and mine against the halo
    pseudo-particles, and return the fully-corrected per-particle
    (den, nden) plus the data phase 2 needs.

    den_p/nden_p: current per-particle densities (dropped rows hold fills).
    Returns (den_p, nden_p, odata, rescued, unres)."""
    Pn = pred.shape[0]
    order, valid, opos, ovel = _pack_dropped(pred, vel, dropped, R)
    fl, fr = _both_ways({"pos": opos, "vel": ovel, "valid": valid}, axis)
    vall = jnp.concatenate([valid, fl["valid"], fr["valid"]])
    opos_all = jnp.where(
        vall[:, None],
        jnp.concatenate([opos, fl["pos"], fr["pos"]], axis=0), _FAR)

    local_pos = jnp.where((active > 0)[:, None], pred, _FAR)
    den_all, nden_all, (cw, cwn) = _density_sweep(
        opos_all, [{"pos": local_pos}], params, coeffs, chunk,
        want_corrections=True)
    # mine also see the halo pseudo-particles AND the neighbors' dropped
    # rows (absent from the halo planes by definition)
    nbr_pos = [jnp.where(d["valid"][:, None], d["pos"], _FAR)
               for d in (fl, fr)]
    den_h, nden_h, _ = _density_sweep(
        opos, [{"pos": halo_pos}] + [{"pos": p} for p in nbr_pos],
        params, coeffs, chunk)
    my_den = den_all[:R] + den_h + DENSITY_PADDING
    my_nden = nden_all[:R] + nden_h + DENSITY_PADDING

    rescued = jnp.zeros((Pn,), bool).at[order].set(valid, mode="drop")
    den_full = jnp.zeros_like(den_p).at[order].set(
        jnp.where(valid, my_den, 0.0), mode="drop")
    nden_full = jnp.zeros_like(nden_p).at[order].set(
        jnp.where(valid, my_nden, 0.0), mode="drop")
    # residents gain the dropped contributions; rescued rows take their
    # exact sums; beyond-budget rows keep fills (counted in unres)
    den_p = jnp.where(rescued, den_full,
                      jnp.where(dropped, den_p, den_p + cw))
    nden_p = jnp.where(rescued, nden_full,
                       jnp.where(dropped, nden_p, nden_p + cwn))
    odata = {"order": order, "valid": valid, "pos": opos, "vel": ovel,
             "den": my_den, "nden": my_nden}
    unres = (jnp.sum(dropped) - jnp.sum(valid)).astype(jnp.int32)
    return den_p, nden_p, odata, rescued, unres


def _rescue_force_common(acc, pred, vel, active, dropped, den, nden,
                         odata, rescued, halo, params, coeffs, axis, chunk):
    """Phase-2 rescue: pair forces for every pair involving a dropped
    particle, both sides. `den`/`nden` are the CORRECTED per-particle
    densities; `halo` is the pseudo-particle dict (pos, vel, den, nden).
    Returns the corrected per-particle accelerations."""
    Pn, dim = pred.shape
    R = odata["order"].shape[0]

    def eos(d, nd):
        return (params.pressure_scalar * (d - params.target_density),
                params.near_pressure_scalar * nd)

    mine = {"pos": odata["pos"], "vel": odata["vel"], "den": odata["den"],
            "nden": odata["nden"], "valid": odata["valid"]}
    fl, fr = _both_ways(dict(mine), axis)

    def qrows(d, ids):
        prs, nprs = eos(d["den"], d["nden"])
        v = d["valid"]
        return {"pos": jnp.where(v[:, None], d["pos"], _FAR),
                "vel": d["vel"],
                "den": jnp.where(v, d["den"], 1.0),
                "nden": jnp.where(v, d["nden"], 1.0),
                "prs": jnp.where(v, prs, 0.0),
                "nprs": jnp.where(v, nprs, 0.0),
                "id": ids}

    my_ids = jnp.where(odata["valid"], odata["order"], -1)
    neg = jnp.full((R,), -1, jnp.int32)
    q_all = jax.tree.map(
        lambda a, b, c: jnp.concatenate([a, b, c], axis=0),
        qrows(mine, my_ids), qrows(fl, neg), qrows(fr, neg))

    iota = jnp.arange(Pn, dtype=jnp.int32)
    unres = dropped & ~rescued
    prs, nprs = eos(den, nden)
    locals_grp = {
        "pos": jnp.where((active > 0)[:, None], pred, _FAR),
        "vel": vel,
        "den": jnp.where(den > 0, den, 1.0),
        "nden": jnp.where(nden > 0, nden, 1.0),
        "prs": prs, "nprs": nprs,
        # beyond-budget rows carry fill densities that would detonate a
        # pair force — they are out of the physics this step (counted)
        "id": jnp.where(active > 0, jnp.where(unres, -3, iota), -2),
    }
    pf_all, vf_all, (pf_j, vf_j) = _force_sweep(
        q_all, [locals_grp], params, coeffs, chunk, want_corrections=True)

    hprs, hnprs = eos(halo["den"], halo["nden"])
    halo_grp = {"pos": halo["pos"], "vel": halo["vel"],
                "den": jnp.where(halo["den"] > 0, halo["den"], 1.0),
                "nden": jnp.where(halo["nden"] > 0, halo["nden"], 1.0),
                "prs": hprs, "nprs": hnprs,
                "id": jnp.full((halo["pos"].shape[0],), -1, jnp.int32)}
    nbr_grps = [qrows(fl, neg), qrows(fr, neg)]
    q_mine = jax.tree.map(lambda a: a[:R], q_all)
    pf_h, vf_h, _ = _force_sweep(q_mine, [halo_grp] + nbr_grps, params,
                                 coeffs, chunk)

    my_den_safe = jnp.where(odata["valid"], odata["den"], 1.0)
    acc_o = ((pf_all[:R] + pf_h) / my_den_safe[:, None]
             + params.viscosity_strength * (vf_all[:R] + vf_h))
    acc_full = jnp.zeros_like(acc).at[odata["order"]].set(
        jnp.where(odata["valid"][:, None], acc_o, 0.0), mode="drop")
    den_safe = jnp.where(den > 0, den, 1.0)
    acc_corr = (pf_j / den_safe[:, None]
                + params.viscosity_strength * vf_j)
    return jnp.where(rescued[:, None], acc_full,
                     jnp.where(dropped[:, None], acc, acc + acc_corr))


def _migrate(state_local, active, params, cfg, gx_loc, axis, mig_cap: int):
    """Move particles whose predicted cell-x left the local slab to the
    neighbor device (one slab per step max)."""
    ndev = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    origin = _grid_origin_static(params, cfg)
    cx = jnp.floor(
        (state_local.predicted[:, 0] - origin[0]) / params.smoothing_radius
    ).astype(jnp.int32)
    cx = jnp.clip(cx, 0, cfg.grid_dims[0] - 1)
    dev_target = jnp.clip(cx // gx_loc, 0, ndev - 1)
    go_left = (dev_target < me) & (active > 0)
    go_right = (dev_target > me) & (active > 0)

    def pack(direction_mask):
        """Gather up to mig_cap rows flagged by direction_mask."""
        prio = jnp.where(direction_mask, 0, 1)
        order = jnp.argsort(prio)[:mig_cap]
        valid = jnp.take(direction_mask, order)
        rows = {
            "pos": jnp.take(state_local.pos, order, axis=0),
            "vel": jnp.take(state_local.vel, order, axis=0),
            "predicted": jnp.take(state_local.predicted, order, axis=0),
            "ids": jnp.take(state_local.ids, order),
            "valid": valid.astype(jnp.float32),
        }
        sent = jnp.sum(valid)
        dropped = jnp.sum(direction_mask) - sent  # re-migrates next step
        return rows, order, valid, dropped

    out_l, ord_l, val_l, drop_l = pack(go_left)
    out_r, ord_r, val_r, drop_r = pack(go_right)

    in_from_right = jax.tree.map(
        lambda x: jax.lax.ppermute(
            x, axis, [(d, (d - 1) % ndev) for d in range(ndev)]), out_l)
    in_from_left = jax.tree.map(
        lambda x: jax.lax.ppermute(
            x, axis, [(d, (d + 1) % ndev) for d in range(ndev)]), out_r)
    # wrapped edges carry nothing
    in_from_right["valid"] = jnp.where(me == ndev - 1, 0.0,
                                       in_from_right["valid"])
    in_from_left["valid"] = jnp.where(me == 0, 0.0, in_from_left["valid"])

    # deactivate departed rows
    active = active.at[ord_l].set(
        jnp.where(val_l, 0.0, jnp.take(active, ord_l)))
    active = active.at[ord_r].set(
        jnp.where(val_r, 0.0, jnp.take(active, ord_r)))

    # merge arrivals into free slots
    def merge(state_local, active, inc):
        n_in = inc["valid"].shape[0]
        free_order = jnp.argsort(active)[:n_in]  # inactive slots first
        can_take = jnp.take(active, free_order) == 0.0
        take = (inc["valid"] > 0) & can_take
        lost = jnp.sum(inc["valid"]) - jnp.sum(take)

        def put(arr, rows, fill_mask):
            cur = jnp.take(arr, free_order, axis=0)
            sel = take.reshape((-1,) + (1,) * (arr.ndim - 1))
            return arr.at[free_order].set(jnp.where(sel, rows, cur))

        new = dataclasses.replace(
            state_local,
            pos=put(state_local.pos, inc["pos"], take),
            vel=put(state_local.vel, inc["vel"], take),
            predicted=put(state_local.predicted, inc["predicted"], take),
            ids=put(state_local.ids, inc["ids"], take),
        )
        active = active.at[free_order].set(
            jnp.where(take, 1.0, jnp.take(active, free_order)))
        return new, active, lost

    state_local, active, lost_r = merge(state_local, active, in_from_right)
    state_local, active, lost_l = merge(state_local, active, in_from_left)
    lost = (lost_r + lost_l + drop_l * 0).astype(jnp.float32)
    return state_local, active, lost


def make_domain_step(mesh: Mesh, cfg: SimConfig, mig_cap: int = 256,
                     rescue_cap: int = 256):
    """Build the shard_map'ped step: (state, active, params) → (state, active,
    lost). State rows are sharded over the mesh; scalars replicated."""
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    gx = cfg.grid_dims[0]
    if cfg.grid_frame != "world":
        raise ValueError(
            "the domain-decomposed step shards x-slabs of a static WORLD "
            "grid (_grid_origin_static); grid_frame='container' is a "
            "single-chip layout optimization — drop it for multi-chip")
    if gx % ndev:
        raise ValueError(f"grid_dims[0]={gx} not divisible by {ndev}")
    gx_loc = gx // ndev

    row = P(axis)
    row2 = P(axis, None)

    state_spec = FluidState(
        pos=row2, vel=row2, predicted=row2, acc=row2, density=row,
        near_density=row, pressure=row, near_pressure=row,
        step_count=P(), time=P(), overflow=P(), overflow_total=P(),
        ids=row)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(state_spec, row, P()),
             out_specs=(state_spec, row, P()),
             check_vma=False)
    def domain_step(state, active, params):
        coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
        den, nden, prs, nprs, acc, overflow = _sph_local(
            state.predicted, state.vel, active, params, coeffs, cfg,
            gx_loc, axis, rescue_cap=rescue_cap)
        t_new = state.time + params.dt
        pos, vel, predicted = integrate_mod.integrate(
            state.pos, state.vel, acc, params, t_new)
        # keep inactive slots inert and far away
        act = active[:, None]
        pos = jnp.where(act > 0, pos, _FAR)
        vel = jnp.where(act > 0, vel, 0.0)
        predicted = jnp.where(act > 0, predicted, _FAR)
        state = FluidState(
            pos=pos, vel=vel, predicted=predicted, acc=acc,
            density=den, near_density=nden, pressure=prs, near_pressure=nprs,
            step_count=state.step_count + 1, time=t_new,
            overflow=jax.lax.psum(overflow, axis),
            overflow_total=state.overflow_total
            + jax.lax.psum(overflow, axis).astype(jnp.float32),
            ids=state.ids)
        state, active, lost = _migrate(state, active, params, cfg, gx_loc,
                                       axis, mig_cap)
        lost_total = jax.lax.psum(lost, axis)
        return state, active, lost_total

    return jax.jit(domain_step)


def make_domain_rollout(mesh: Mesh, cfg: SimConfig, mig_cap: int = 256,
                        rescue_cap: int = 256):
    """Multi-step rollout of the domain step under one ``lax.scan`` — the
    sharded counterpart of ops.step.rollout. One dispatch per *chunk* instead
    of one per step (the reference pays one submit per frame,
    /root/reference/src/fluid_compute.rs:396).

    Returns ``rollout(state, active, params, num_steps) ->
    (state, active, lost_sum)`` with donated state/active buffers and the
    per-step migration losses summed on-device.
    """
    step = make_domain_step(mesh, cfg, mig_cap=mig_cap,
                            rescue_cap=rescue_cap)

    @partial(jax.jit, static_argnums=(3,), donate_argnums=(0, 1))
    def rollout(state, active, params, num_steps: int):
        def body(carry, _):
            st, act, lost = carry
            st, act, l = step(st, act, params)
            return (st, act, lost + l), None

        init = (state, active, jnp.zeros((), jnp.float32))
        (state, active, lost), _ = jax.lax.scan(
            body, init, None, length=num_steps)
        return state, active, lost

    return rollout


def gather_dense(state, active) -> tuple:
    """Host-side: extract the active particles (order not meaningful across
    devices). Returns (positions, velocities) as numpy arrays."""
    import numpy as np
    act = np.asarray(active) > 0
    return (np.asarray(state.pos)[act], np.asarray(state.vel)[act])

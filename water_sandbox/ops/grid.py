"""Neighbor-search pipelines (XLA path).

The reference's GPU pipeline is: hash → 136-stage global bitonic sort →
atomicMin cell offsets → data-dependent while-loop walk over 27 neighbor
cells (/root/reference/assets/{simulation,bitonic_sort}.wgsl; pass graph
src/fluid_compute.rs:309-364). That shape — per-thread random access chasing
sorted runs — needs data-dependent loops that XLA cannot express as fused
array programs. None of it is translated:

* ``bucket_grid`` (the default): particles are scattered once per
  step into a dense cell-bucket tensor ``(gx, gy, gz, C, features)`` (C =
  fixed per-cell capacity). The 3^dim neighbor cells are then obtained by
  ``jnp.roll`` of the *cell grid* — pure contiguous data movement — and each
  cell computes a dense masked C×C pair block against each rolled
  neighborhood. No data-dependent control flow, no per-row gathers in the
  hot loop; the only irregular memory ops are one argsort, one n-row
  scatter, and one n-row gather-back per pass.

* ``hash_grid``: exact emulation of the reference's hashed cell table —
  including hash-collision aliasing and per-offset multi-count semantics —
  via sorted-run gathers. Slow by design; it exists for parity validation
  against the dense oracle (tests/test_grid.py), not for production.

Grid-boundary notes (bucket mode): the grid anchors one cell below the
minimum predicted position each step, so the fluid can move anywhere without
rehash-table tuning; out-of-range cells clamp to the border. ``jnp.roll``
wraparound at the border can only alias cells that are ≥ grid-extent apart
in space, so the per-pair distance filter (same as the reference relies on
for its hash collisions, simulation.wgsl:154,238) keeps it exact.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from . import hashing, kernels

Array = jax.Array

# Padded-position sentinel: farther than any support radius but small enough
# that squared distances stay finite in float32.
_FAR = 1.0e15


@dataclasses.dataclass(frozen=True)
class BucketGrid:
    """Cell-bucket neighbor structure (pytree) for one step — slot-major.

    Layout: the *cell* axis is the minor-most dimension, so every pairwise
    op vectorizes over all cells; the bucket slot C is the next axis.
    Feature components are separate (C, num_cells) planes stacked on a
    leading axis.

    ``cell_pos``: (dim, C, num_cells), padding slots hold _FAR;
    ``cell_vel``: (dim, C, num_cells), padding 0;
    ``cell_mask``: (C, num_cells), 1.0 for real particles;
    ``addr``: (n,) each particle's flat (slot·num_cells + cell) address, or
    C·num_cells (one-past-end) for capacity-overflow particles;
    ``overflow``: () int32 count of dropped particles.
    """

    cell_pos: Array
    cell_vel: Array
    cell_mask: Array
    addr: Array
    origin: Array
    overflow: Array


jax.tree_util.register_dataclass(
    BucketGrid,
    data_fields=["cell_pos", "cell_vel", "cell_mask", "addr", "origin",
                 "overflow"],
    meta_fields=[],
)


@dataclasses.dataclass(frozen=True)
class HashGrid:
    """Reference-faithful hashed table (pytree): ``order`` the sorted
    permutation (the reference's particle_indicies after its bitonic sort),
    ``sorted_keys`` its hash keys, ``starts`` the first sorted rank per hash
    (cell_offsets via atomicMin, bitonic_sort.wgsl:49-59)."""

    order: Array
    sorted_keys: Array
    starts: Array
    overflow: Array


jax.tree_util.register_dataclass(
    HashGrid,
    data_fields=["order", "sorted_keys", "starts", "overflow"],
    meta_fields=[],
)


def num_cells(cfg: SimConfig) -> int:
    return math.prod(cfg.grid_dims)


# --------------------------------------------------------------------------
# bucket grid
# --------------------------------------------------------------------------

def build_bucket_grid(predicted: Array, vel: Array, params: SimParams,
                      cfg: SimConfig, time: Array | None = None
                      ) -> BucketGrid:
    """cell ids → argsort → run starts (scatter-min, the functional analogue
    of the reference's atomicMin) → in-cell slots → scatter into slot-major
    buckets.

    ``time`` feeds the container pose when cfg.grid_frame == 'container'
    (hashing.key_coords); the buckets still store world coordinates."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    dims = cfg.grid_dims
    nc = num_cells(cfg)
    cap = cfg.cell_capacity
    dtype = predicted.dtype

    kpred = hashing.key_coords(predicted, params, cfg, time)
    origin = hashing.grid_origin(kpred, h)
    _, cid = hashing.bounded_cell_ids(kpred, h, origin, dims)

    order = jnp.argsort(cid).astype(jnp.int32)
    sorted_cid = cid[order]
    ranks = jnp.arange(n, dtype=jnp.int32)
    # rank-within-cell via a running max over run boundaries — no (nc,)
    # scatter-min table needed (the functional analogue of the reference's
    # atomicMin cell offsets, bitonic_sort.wgsl:49-59)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cid[1:] != sorted_cid[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, ranks, 0))
    slot = ranks - run_start
    ok = slot < cap
    flat = jnp.where(ok, slot * nc + sorted_cid, cap * nc)

    def scatter(values, fill):
        out = jnp.full((cap * nc + 1,), fill, dtype)
        # every particle has a distinct (slot, cell) address
        return out.at[flat].set(values, mode="drop",
                                unique_indices=True)[:-1].reshape(cap, nc)

    cell_pos = jnp.stack(
        [scatter(jnp.take(predicted[:, a], order), _FAR) for a in range(dim)])
    cell_vel = jnp.stack(
        [scatter(jnp.take(vel[:, a], order), 0.0) for a in range(dim)])
    cell_mask = scatter(jnp.ones((n,), dtype), 0.0)

    # addr in particle order (invert the sort): addr[order[r]] = flat[r]
    addr = jnp.zeros((n,), jnp.int32).at[order].set(flat, unique_indices=True)
    overflow = (n - jnp.sum(ok)).astype(jnp.int32)
    return BucketGrid(cell_pos=cell_pos, cell_vel=cell_vel,
                      cell_mask=cell_mask, addr=addr, origin=origin,
                      overflow=overflow)


def _roll_shifts(dims: tuple) -> Array:
    """(3^dim,) FLAT roll shifts, one per neighbor offset.

    Because cell ids are row-major (x slowest — ops/hashing.py), the cell at
    offset (ox, oy, oz) from cell c has flat id c + (ox·gy + oy)·gz + oz, so
    the whole 3-D neighborhood shift is a single 1-D rotation of the flat
    cell axis: no reshape, no relayout, contiguous data movement. Cells
    that "wrap" across a row boundary alias spatially distant cells, which
    the per-pair distance filter removes — the same argument the reference
    relies on for its hash collisions (simulation.wgsl:154,238). shift is
    negated so cell c sees cell c+off. 3-D offset order matches the
    reference OFFSET_TABLE (simulation.wgsl:6-34)."""
    import itertools
    offs = list(itertools.product((-1, 0, 1), repeat=len(dims)))
    strides = [1] * len(dims)
    for a in range(len(dims) - 2, -1, -1):
        strides[a] = strides[a + 1] * dims[a + 1]
    return jnp.asarray(
        [-sum(o * s for o, s in zip(off, strides)) for off in offs],
        jnp.int32)


def _py_roll_shifts(dims: tuple) -> list[int]:
    """_roll_shifts as Python ints, for the statically-unrolled offset loop
    (the sharded path: the SPMD partitioner can only turn a roll into a
    boundary-slab halo exchange when the shift is a compile-time constant —
    a traced shift forces it to all-gather the whole cell grid instead,
    verified by tests/test_parallel.py::test_gspmd_lowers_rolls_to_collective_permute)."""
    import itertools
    offs = list(itertools.product((-1, 0, 1), repeat=len(dims)))
    strides = [1] * len(dims)
    for a in range(len(dims) - 2, -1, -1):
        strides[a] = strides[a + 1] * dims[a + 1]
    return [-sum(o * s for o, s in zip(off, strides)) for off in offs]


def _rolled_dyn(x: Array, flat_shift: Array, dims: tuple) -> Array:
    """Rotate the trailing (flat cell) axis by a traced shift."""
    return jnp.roll(x, flat_shift, axis=-1)


def _offset_fold(body, init, dims: tuple, unroll: bool):
    """Fold `body(carry, shift) -> carry` over the 3^dim neighbor shifts:
    a compact lax.scan for the single-device path, a static Python unroll
    (constant shifts) when the cell axis is sharded (see _py_roll_shifts)."""
    if unroll:
        carry = init
        for sh in _py_roll_shifts(dims):
            carry, _ = body(carry, sh)  # python int -> static roll
        return carry
    carry, _ = jax.lax.scan(body, init, _roll_shifts(dims))
    return carry


def bucket_density_pass(grid: BucketGrid, params: SimParams,
                        coeffs: KernelCoeffs, cfg: SimConfig,
                        unroll: bool = False):
    """Density + EOS over the slot-major bucket layout
    (simulation.wgsl:144-195).

    One lax.scan over the 3^dim neighbor offsets: the body rolls the cell
    grid (contiguous data movement) and accumulates a dense masked Cq×Cn pair
    block per cell, vectorized over all cells on the minor axis. Returns
    cell-layout (den, nden, prs, nprs), each (C, num_cells).
    Self-interaction included, faithful to the reference walk."""
    h = params.smoothing_radius
    dims = cfg.grid_dims
    P, M = grid.cell_pos, grid.cell_mask            # (dim, C, nc), (C, nc)
    dim = P.shape[0]
    PM = jnp.concatenate([P, M[None]], axis=0)      # (dim+1, C, nc)

    def body(carry, shift):
        den, nden = carry
        rolled = _rolled_dyn(PM, shift, dims)
        # pair block: query slots on axis 0, neighbor slots on axis 1,
        # cells on the minor axis
        dist2 = jnp.zeros((P.shape[1], P.shape[1], P.shape[2]), P.dtype)
        for a in range(dim):
            d_a = rolled[a][None, :, :] - P[a][:, None, :]  # (Cq, Cn, nc)
            dist2 = dist2 + d_a * d_a
        dist = jnp.sqrt(dist2)
        m = jnp.where(kernels.support_mask(dist, h), rolled[dim][None], 0.0)
        # clamp before kernel eval: sentinel distances would overflow f32 in
        # the (h-d)^3 term and turn the masked product into 0·inf = NaN
        dc = jnp.minimum(dist, h)
        den = den + jnp.sum(m * kernels.w_density(dc, h, coeffs), axis=1)
        nden = nden + jnp.sum(m * kernels.w_near(dc, h, coeffs), axis=1)
        return (den, nden), None

    den, nden = _offset_fold(
        body, (jnp.zeros_like(M), jnp.zeros_like(M)), dims, unroll)

    den = den + DENSITY_PADDING
    nden = nden + DENSITY_PADDING
    prs = params.pressure_scalar * (den - params.target_density)
    nprs = params.near_pressure_scalar * nden
    return den, nden, prs, nprs


def bucket_force_pass(grid: BucketGrid, den: Array, nden: Array, prs: Array,
                      nprs: Array, params: SimParams, coeffs: KernelCoeffs,
                      cfg: SimConfig, unroll: bool = False) -> Array:
    """Pressure + viscosity acceleration over the slot-major bucket layout
    (simulation.wgsl:198-269), one lax.scan over neighbor offsets. Self pair
    excluded only for the zero offset. Returns cell acc (dim, C, num_cells)."""
    h = params.smoothing_radius
    dims = cfg.grid_dims
    P, V, M = grid.cell_pos, grid.cell_vel, grid.cell_mask
    dim, cap, nc = P.shape
    dtype = P.dtype

    eye = jnp.eye(cap, dtype=dtype)[:, :, None]      # (Cq, Cn, 1)
    feats = jnp.concatenate(
        [P, V, M[None], den[None], nden[None], prs[None], nprs[None]], axis=0)

    def body(carry, shift):
        pressure_force, viscosity_force = carry
        rolled = _rolled_dyn(feats, shift, dims)
        MQ = rolled[2 * dim]
        dQ, ndQ = rolled[2 * dim + 1], rolled[2 * dim + 2]
        pQ, npQ = rolled[2 * dim + 3], rolled[2 * dim + 4]

        dist2 = jnp.zeros((cap, cap, nc), dtype)
        disp = []
        for a in range(dim):
            d_a = rolled[a][None, :, :] - P[a][:, None, :]  # (Cq, Cn, nc)
            disp.append(d_a)
            dist2 = dist2 + d_a * d_a
        dist = jnp.sqrt(dist2)
        m = jnp.where(kernels.support_mask(dist, h), MQ[None], 0.0)
        is_center = jnp.asarray(shift == 0, dtype)
        m = m * (1.0 - is_center * eye)  # skip self in the center cell only
        dc = jnp.minimum(dist, h)  # see density pass: avoid 0·inf = NaN

        inv_dist = jnp.where(dist > 0.0, 1.0 / jnp.where(dist > 0.0, dist, 1.0),
                             0.0)
        zero_dist = (dist == 0.0).astype(dtype)

        shared_p = (prs[:, None, :] + pQ[None, :, :]) * 0.5
        shared_np = (nprs[:, None, :] + npQ[None, :, :]) * 0.5
        # neighbor densities: padded slots hold 0 — guard the divide, the
        # mask zeroes those slots anyway
        dQ_safe = jnp.where(dQ > 0.0, dQ, 1.0)[None]
        ndQ_safe = jnp.where(ndQ > 0.0, ndQ, 1.0)[None]
        scale = m * (shared_p * kernels.dw_density(dc, h, coeffs) / dQ_safe
                     + shared_np * kernels.dw_near(dc, h, coeffs) / ndQ_safe)
        w_visc = m * kernels.w_viscosity(dc, h, coeffs)

        for a in range(dim):
            # direction: disp/dist, or +y when dist == 0 (wgsl:243-248)
            dir_a = disp[a] * inv_dist
            if a == 1:
                dir_a = dir_a + zero_dist
            pressure_force = pressure_force.at[a].add(
                jnp.sum(dir_a * scale, axis=1))
            viscosity_force = viscosity_force.at[a].add(jnp.sum(
                (rolled[dim + a][None, :, :] - V[a][:, None, :]) * w_visc,
                axis=1))
        return (pressure_force, viscosity_force), None

    pressure_force, viscosity_force = _offset_fold(
        body, (jnp.zeros_like(P), jnp.zeros_like(P)), dims, unroll)

    return (pressure_force / den[None]
            + params.viscosity_strength * viscosity_force)


def _from_cells(cell_arr: Array, addr: Array, fill) -> Array:
    """Gather per-particle values back from cell layout. Overflow particles
    (addr == one-past-end) get `fill`.

    cell_arr: (C, nc) scalar plane → (n,), or (dim, C, nc) → (n, dim)."""
    if cell_arr.ndim == 2:
        flat = cell_arr.reshape(-1)
        flat = jnp.concatenate([flat, jnp.full((1,), fill, flat.dtype)])
        return jnp.take(flat, addr)
    comps = [_from_cells(cell_arr[a], addr, fill)
             for a in range(cell_arr.shape[0])]
    return jnp.stack(comps, axis=-1)


def bucket_sph(predicted: Array, vel: Array, params: SimParams,
               coeffs: KernelCoeffs, cfg: SimConfig, constrain=None,
               time: Array | None = None):
    """Full bucket-grid SPH: returns per-particle
    (den, nden, prs, nprs, acc, overflow).

    Capacity-overflow handling: with ``cfg.rescue_capacity > 0``, dropped
    particles get EXACT physics via the dense rescue sweep (ops/rescue.py) —
    densities are corrected before the force pass (scattered back into the
    cell planes) and every dropped↔any pair force is added afterwards. The
    returned ``overflow`` then counts only particles beyond the rescue
    budget (still dropped, still loud). With rescue disabled, dropped
    particles get rest-density and zero acceleration and all are counted.

    ``constrain``: optional fn applied to every (..., num_cells) cell-layout
    array — the multi-chip GSPMD path (parallel/gspmd.py) passes a
    with_sharding_constraint that shards the cell axis over the mesh; the
    rolls then lower to halo exchanges between mesh neighbors."""
    from . import rescue as rescue_mod

    unroll = constrain is not None
    grid = build_bucket_grid(predicted, vel, params, cfg, time=time)
    if constrain is not None:
        grid = BucketGrid(
            cell_pos=constrain(grid.cell_pos),
            cell_vel=constrain(grid.cell_vel),
            cell_mask=constrain(grid.cell_mask),
            addr=grid.addr, origin=grid.origin, overflow=grid.overflow)
    den_c, nden_c, prs_c, nprs_c = bucket_density_pass(grid, params, coeffs,
                                                       cfg, unroll=unroll)
    overflow = grid.overflow

    if cfg.rescue_capacity > 0:
        cap, nc = cfg.cell_capacity, num_cells(cfg)
        dropped = grid.addr == cap * nc
        den = _from_cells(den_c, grid.addr, params.target_density)
        nden = _from_cells(nden_c, grid.addr, DENSITY_PADDING)

        small = rescue_mod.small_budget(cfg)

        def with_rescue(budget):
            def fn(den, nden, den_c, nden_c):
                den, nden, rescued, unrescued = rescue_mod.density_rescue(
                    predicted, dropped, den, nden, params, coeffs, cfg,
                    budget=budget)
                # corrected densities must be visible to the force pass
                den_c = den_c.reshape(-1).at[grid.addr].set(
                    den, mode="drop").reshape(cap, nc)
                nden_c = nden_c.reshape(-1).at[grid.addr].set(
                    nden, mode="drop").reshape(cap, nc)
                return den, nden, den_c, nden_c, rescued, unrescued
            return fn

        def no_rescue(den, nden, den_c, nden_c):
            return (den, nden, den_c, nden_c,
                    jnp.zeros(dropped.shape, bool), overflow)

        # two-tier budget: steady-state overflow is typically a handful of
        # particles; sweep cost is O(budget · n), so the full budget only
        # runs when the small tier cannot cover the count
        den, nden, den_c, nden_c, rescued, unrescued = jax.lax.cond(
            overflow > 0,
            lambda *a: jax.lax.cond(overflow <= small, with_rescue(small),
                                    with_rescue(cfg.rescue_capacity), *a),
            no_rescue, den, nden, den_c, nden_c)
        prs_c = params.pressure_scalar * (den_c - params.target_density)
        nprs_c = params.near_pressure_scalar * nden_c
        prs = params.pressure_scalar * (den - params.target_density)
        nprs = params.near_pressure_scalar * nden

        acc_c = bucket_force_pass(grid, den_c, nden_c, prs_c, nprs_c, params,
                                  coeffs, cfg, unroll=unroll)
        acc = _from_cells(acc_c, grid.addr, 0.0)

        def f_rescue(budget):
            return lambda a: rescue_mod.force_rescue(
                predicted, vel, den, nden, prs, nprs, dropped, a, params,
                coeffs, cfg, budget=budget)

        acc = jax.lax.cond(
            overflow > 0,
            lambda a: jax.lax.cond(overflow <= small, f_rescue(small),
                                   f_rescue(cfg.rescue_capacity), a),
            lambda a: a, acc)
        return den, nden, prs, nprs, acc, unrescued

    acc_c = bucket_force_pass(grid, den_c, nden_c, prs_c, nprs_c, params,
                              coeffs, cfg, unroll=unroll)
    den = _from_cells(den_c, grid.addr, params.target_density)
    nden = _from_cells(nden_c, grid.addr, DENSITY_PADDING)
    prs = _from_cells(prs_c, grid.addr, 0.0)
    nprs = _from_cells(nprs_c, grid.addr, 0.0)
    acc = _from_cells(acc_c, grid.addr, 0.0)
    return den, nden, prs, nprs, acc, grid.overflow


# --------------------------------------------------------------------------
# hash grid (reference-parity mode)
# --------------------------------------------------------------------------

def build_hash_grid(predicted: Array, params: SimParams,
                    cfg: SimConfig) -> HashGrid:
    """hash_particles (simulation.wgsl:131-141) + bitonic sort
    (bitonic_sort.wgsl:23-46 → one XLA sort) + calculate_cell_offsets
    (:49-59 → scatter-min).

    ``overflow`` counts sorted entries beyond the ``cfg.max_run`` prefix of
    their same-hash run: the reference walks runs unboundedly
    (simulation.wgsl:167-183) while `_hash_candidates` walks at most max_run
    entries, so any such entry is invisible as a neighbor candidate and the
    emulation is only exact when this count is 0."""
    n = predicted.shape[0]
    table = cfg.table_size
    cell = hashing.get_cell(predicted, params.smoothing_radius)
    keys = hashing.reference_hash(cell, table)
    order = jnp.argsort(keys).astype(jnp.int32)
    sorted_keys = keys[order]
    ranks = jnp.arange(n, dtype=jnp.int32)
    starts = jnp.full((table,), n, jnp.int32).at[sorted_keys].min(ranks)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_keys[1:] != sorted_keys[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, ranks, 0))
    truncated = jnp.sum(ranks - run_start >= cfg.max_run).astype(jnp.int32)
    return HashGrid(order=order, sorted_keys=sorted_keys, starts=starts,
                    overflow=truncated)


def _hash_candidates(chunk_pred: Array, grid: HashGrid, params: SimParams,
                     cfg: SimConfig) -> Array:
    """Reference-walk emulation: for each of the 3^dim offsets, take up to
    ``max_run`` sorted ranks from starts[hash] while the key matches
    (simulation.wgsl:162-183). Duplicates across colliding offsets are kept —
    faithful multi-count. Sentinel n marks invalid."""
    n = grid.order.shape[0]
    table = cfg.table_size
    cell = hashing.get_cell(chunk_pred, params.smoothing_radius)
    offs = hashing.neighbor_offsets(chunk_pred.shape[-1])
    nkeys = hashing.reference_hash(cell[:, None, :] + offs[None, :, :], table)
    start = jnp.take(grid.starts, nkeys, axis=0)          # (c, m)
    r = start[:, :, None] + jnp.arange(cfg.max_run, dtype=jnp.int32)
    in_range = r < n
    r_safe = jnp.where(in_range, r, 0)
    run_keys = jnp.take(grid.sorted_keys, r_safe, axis=0)
    match = in_range & (run_keys == nkeys[:, :, None])
    idx = jnp.where(match, jnp.take(grid.order, r_safe, axis=0), jnp.int32(n))
    return idx.reshape(chunk_pred.shape[0], -1)


def _pad_rows(arr: Array, pad_value) -> Array:
    pad = jnp.full((1,) + arr.shape[1:], pad_value, arr.dtype)
    return jnp.concatenate([arr, pad], axis=0)


def _chunked_map(fn, per_chunk_args: tuple, n: int, chunk: int):
    """Run fn over particle chunks of the (n, ...) inputs; pads the tail."""
    n_pad = -(-n // chunk) * chunk

    def pad(a, value):
        if n_pad == n:
            return a
        block = jnp.full((n_pad - n,) + a.shape[1:], value, a.dtype)
        return jnp.concatenate([a, block], axis=0)

    padded = tuple(pad(a, v).reshape((n_pad // chunk, chunk) + a.shape[1:])
                   for a, v in per_chunk_args)
    out = jax.lax.map(lambda args: fn(*args), padded)
    return jax.tree_util.tree_map(
        lambda o: o.reshape((n_pad,) + o.shape[2:])[:n], out)


def hash_density_pass(predicted: Array, grid: HashGrid, params: SimParams,
                      coeffs: KernelCoeffs, cfg: SimConfig):
    """Grid-accelerated density + EOS with reference hash semantics."""
    n = predicted.shape[0]
    h = params.smoothing_radius
    pred_pad = _pad_rows(predicted, _FAR)

    def chunk_fn(chunk_pred):
        idx = _hash_candidates(chunk_pred, grid, params, cfg)
        npos = jnp.take(pred_pad, idx, axis=0)
        disp = npos - chunk_pred[:, None, :]
        dist = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
        m = kernels.support_mask(dist, h)
        dc = jnp.minimum(dist, h)  # sentinel distances overflow the kernels
        w = jnp.where(m, kernels.w_density(dc, h, coeffs), 0.0)
        wn = jnp.where(m, kernels.w_near(dc, h, coeffs), 0.0)
        return jnp.sum(w, axis=1), jnp.sum(wn, axis=1)

    density, near_density = _chunked_map(
        chunk_fn, ((predicted, _FAR),), n, cfg.chunk)
    density = density + DENSITY_PADDING
    near_density = near_density + DENSITY_PADDING
    pressure = params.pressure_scalar * (density - params.target_density)
    near_pressure = params.near_pressure_scalar * near_density
    return density, near_density, pressure, near_pressure


def hash_force_pass(predicted: Array, vel: Array, density: Array,
                    near_density: Array, pressure: Array, near_pressure: Array,
                    grid: HashGrid, params: SimParams, coeffs: KernelCoeffs,
                    cfg: SimConfig) -> Array:
    """Grid-accelerated forces with reference hash semantics; self pair
    excluded by index (simulation.wgsl:231-233)."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    pred_pad = _pad_rows(predicted, _FAR)
    vel_pad = _pad_rows(vel, 0.0)
    den_pad = _pad_rows(density, 1.0)
    nden_pad = _pad_rows(near_density, 1.0)
    prs_pad = _pad_rows(pressure, 0.0)
    nprs_pad = _pad_rows(near_pressure, 0.0)
    up = jnp.zeros((dim,), predicted.dtype).at[1].set(1.0)

    def chunk_fn(chunk_pred, chunk_vel, chunk_prs, chunk_nprs, chunk_den,
                 chunk_iota):
        idx = _hash_candidates(chunk_pred, grid, params, cfg)
        npos = jnp.take(pred_pad, idx, axis=0)
        disp = npos - chunk_pred[:, None, :]
        dist = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
        m = kernels.support_mask(dist, h) & (idx != chunk_iota[:, None])
        mf = m.astype(chunk_pred.dtype)
        dc = jnp.minimum(dist, h)  # sentinel distances overflow the kernels

        safe = jnp.where(dist > 0.0, dist, 1.0)
        direction = jnp.where((dist > 0.0)[..., None], disp / safe[..., None],
                              up)
        shared_p = (chunk_prs[:, None] + jnp.take(prs_pad, idx, axis=0)) * 0.5
        shared_np = (chunk_nprs[:, None]
                     + jnp.take(nprs_pad, idx, axis=0)) * 0.5
        scale = mf * (shared_p * kernels.dw_density(dc, h, coeffs)
                      / jnp.take(den_pad, idx, axis=0)
                      + shared_np * kernels.dw_near(dc, h, coeffs)
                      / jnp.take(nden_pad, idx, axis=0))
        pressure_force = jnp.sum(direction * scale[..., None], axis=1)

        w_visc = mf * kernels.w_viscosity(dc, h, coeffs)
        viscosity_force = jnp.sum(
            (jnp.take(vel_pad, idx, axis=0) - chunk_vel[:, None, :])
            * w_visc[..., None], axis=1)
        return (pressure_force / chunk_den[:, None]
                + params.viscosity_strength * viscosity_force)

    iota = jnp.arange(n, dtype=jnp.int32)
    return _chunked_map(
        chunk_fn,
        ((predicted, _FAR), (vel, 0.0), (pressure, 0.0),
         (near_pressure, 0.0), (density, 1.0), (iota, n)),
        n, cfg.chunk)


def hash_sph(predicted: Array, vel: Array, params: SimParams,
             coeffs: KernelCoeffs, cfg: SimConfig):
    """Full reference-semantics SPH via the hashed table."""
    grid = build_hash_grid(predicted, params, cfg)
    den, nden, prs, nprs = hash_density_pass(predicted, grid, params, coeffs,
                                             cfg)
    acc = hash_force_pass(predicted, vel, den, nden, prs, nprs, grid, params,
                          coeffs, cfg)
    return den, nden, prs, nprs, acc, grid.overflow

"""Cell coordinates and spatial-hash keys.

Two key schemes:

* ``reference_hash`` — bit-faithful emulation of the reference's hashed cell
  table (/root/reference/assets/simulation.wgsl:121-128): cell = floor(p/h)
  as i32, bitcast to u32, key = (x·15823 + y·9737333 + z·440817757) mod T
  with wrapping u32 arithmetic and T = particle count. Hash collisions alias
  distinct cells into one bucket; the reference *depends* on the per-pair
  distance filter for correctness, and multi-counts a pair once per
  neighbor-offset whose hash collides (see ``reference_pair_weights``).

* ``bounded_grid`` — collision-free linearized cell ids over a dynamically
  anchored bounded grid (the production scheme; no aliasing, so fixed-capacity
  buckets and clean halo slabs for multi-chip sharding). The x coordinate is
  the *slowest* axis of the linear id so that sorting by id groups particles
  into contiguous x-slabs — the layout the domain decomposition shards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

# Reference hash primes (assets/simulation.wgsl:38-40).
P1 = 15823
P2 = 9737333
P3 = 440817757

# Reference sentinel for "empty" offset-table entries (simulation.wgsl:36).
INF_U32 = 999999999


def get_cell(pos: Array, h: Array) -> Array:
    """floor(p / h) as int32 (simulation.wgsl:121-123)."""
    return jnp.floor(pos / h).astype(jnp.int32)


def reference_hash(cell: Array, table_size: int) -> Array:
    """Wrapping-u32 prime hash mod table_size (simulation.wgsl:125-128).

    Supports dim 2 (x·P1 + y·P2) and dim 3 (x·P1 + y·P2 + z·P3)."""
    c = cell.astype(jnp.uint32)
    primes = jnp.array([P1, P2, P3][: cell.shape[-1]], jnp.uint32)
    acc = jnp.zeros(cell.shape[:-1], jnp.uint32)
    for a in range(cell.shape[-1]):
        acc = acc + c[..., a] * primes[a]
    return (acc % jnp.uint32(table_size)).astype(jnp.int32)


def neighbor_offsets(dim: int) -> Array:
    """The 3^dim neighbor-cell offset table; 3-D order matches the
    reference's OFFSET_TABLE (simulation.wgsl:6-34): x outermost, z innermost,
    each in (-1, 0, 1)."""
    r = jnp.arange(-1, 2, dtype=jnp.int32)
    grids = jnp.meshgrid(*([r] * dim), indexing="ij")
    return jnp.stack([g.reshape(-1) for g in grids], axis=-1)  # (3^dim, dim)


def reference_pair_weights(predicted: Array, h: Array, table_size: int) -> Array:
    """(n, n) multiplicity matrix for the dense oracle in reference-hash mode.

    weight[i, j] = number of neighbor offsets o such that
    hash(cell_i + o) == hash(cell_j) — i.e. how many times the reference's
    27-cell walk visits particle j when processing particle i
    (simulation.wgsl:160-183). With no hash collisions this is exactly the
    0/1 adjacency of the 27-cell neighborhood.
    """
    cell = get_cell(predicted, h)                       # (n, dim)
    key = reference_hash(cell, table_size)              # (n,)
    offs = neighbor_offsets(predicted.shape[-1])        # (m, dim)
    nbr_keys = reference_hash(cell[:, None, :] + offs[None, :, :], table_size)
    return jnp.sum(nbr_keys[:, :, None] == key[None, None, :], axis=1)


def bounded_cell_ids(predicted: Array, h: Array, origin: Array,
                     dims: tuple) -> tuple[Array, Array]:
    """Cell coords (clamped into the grid) and linear ids, x slowest.

    Returns (cell (n,dim) int32 clamped, cid (n,) int32)."""
    cell = jnp.floor((predicted - origin) / h).astype(jnp.int32)
    dims_arr = jnp.asarray(dims, jnp.int32)
    cell = jnp.clip(cell, 0, dims_arr - 1)
    cid = cell[:, 0]
    for a in range(1, len(dims)):
        cid = cid * dims[a] + cell[:, a]
    return cell, cid


def linearize(cell: Array, dims: tuple) -> Array:
    """Linear id of (possibly out-of-range) cell coords; -1 if out of range."""
    dims_arr = jnp.asarray(dims, jnp.int32)
    in_range = jnp.all((cell >= 0) & (cell < dims_arr), axis=-1)
    cid = cell[..., 0]
    for a in range(1, len(dims)):
        cid = cid * dims[a] + cell[..., a]
    return jnp.where(in_range, cid, -1)


def grid_origin(predicted: Array, h: Array) -> Array:
    """Dynamic grid anchor: one cell below the current minimum predicted
    position, so the lower border cells are never clamped targets."""
    return jnp.min(predicted, axis=0) - h


def key_coords(predicted: Array, params, cfg, time: Array | None) -> Array:
    """Coordinates the cell keys are computed from.

    ``cfg.grid_frame == "container"`` maps positions into the (possibly
    translating/yawing) container's BODY frame before binning: the rigid
    map is an isometry, so any pair within h in world space is within
    h·(1+ε) in key space and stays within one cell ring — the coverage
    argument is unchanged — while the static grid now needs to span only
    the box interior, never the yawed sweep's world AABB (the flagship's
    world grid is (168, 44, 80) = 591k cells against a body-frame fluid
    extent of ~(160, 30, 56)). The planes still store WORLD positions and
    the pair passes' distance filter runs on them, so the key frame changes
    performance and float-accumulation order only — never the pair set
    (same exactness class as clamping).

    "world" (default) returns ``predicted`` unchanged.
    """
    if cfg.grid_frame == "world":
        return predicted
    if time is None:
        raise ValueError(
            "grid_frame='container' needs the sim time for the box pose; "
            "this neighbor pipeline does not thread it")
    from . import integrate as integrate_mod
    center, angle = integrate_mod.container_at(params.container, time)
    return integrate_mod._rotate_yaw(predicted - center, angle,
                                     inverse=True)


def default_grid_dims(container_size, smoothing_radius: float, margin: int = 4):
    """Static grid dims covering the container plus a safety margin."""
    import math
    return tuple(int(math.ceil(s / smoothing_radius)) + margin
                 for s in container_size)

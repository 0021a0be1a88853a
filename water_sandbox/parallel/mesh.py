"""Device-mesh helpers for multi-chip runs.

The reference is strictly single-GPU (SURVEY.md §2 parallelism checklist);
this module and its siblings are the scaling layer it never had: a 1-D mesh
along the container's long (x) axis, matching the cell grid's linearization
(x is the slowest cell-id axis, ops/hashing.py), so cell-slab sharding is a
contiguous split and neighbor rolls touch only mesh-adjacent devices.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "x"


def make_mesh(n_devices: int | None = None, axis_name: str = AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def cell_sharding(mesh: Mesh, axis_name: str = AXIS) -> NamedSharding:
    """Shard the trailing (num_cells) axis of cell-layout arrays: contiguous
    x-slabs of the grid when n_devices divides grid_dims[0]."""
    return NamedSharding(mesh, P(*([None] * 0), axis_name))


def constrainer(mesh: Mesh, axis_name: str = AXIS):
    """A `constrain` hook for ops.grid.bucket_sph: shard the last (cell)
    axis of any cell-layout array over the mesh."""
    def constrain(arr):
        spec = P(*([None] * (arr.ndim - 1) + [axis_name]))
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(mesh, spec))
    return constrain


def particle_sharding(mesh: Mesh, ndim: int, axis_name: str = AXIS):
    """Particle arrays (n, ...) sharded on the particle axis."""
    return NamedSharding(mesh, P(*([axis_name] + [None] * (ndim - 1))))

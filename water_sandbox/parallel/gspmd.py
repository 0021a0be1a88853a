"""Multi-chip stepping via GSPMD sharding (compiler-partitioned).

Strategy: shard the *cell grid* along its x axis across a 1-D mesh (the
spatial-domain analogue of sequence parallelism — SURVEY.md §5). Inside a
jitted step the bucket pipeline's `constrain` hook pins every cell-layout
array to that sharding; XLA then partitions the dense per-cell pair math
across devices and lowers the neighbor `jnp.roll`s into one-cell-wide halo
exchanges (collective-permutes between mesh neighbors). Particle
arrays are sharded on the particle axis; the scatter into buckets / gather
back become compiler-inserted all-to-alls, which stay cheap because
particles sorted by cell id are already approximately x-slab-contiguous.

This is the "let XLA insert the collectives" path (scaling-book recipe).
``parallel/domain.py`` is the hand-scheduled shard_map/ppermute counterpart
with explicit halo buffers and particle migration.

Requires cfg.grid_dims[0] % n_devices == 0 for an even slab split.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.params import SimConfig, SimParams
from ..core.state import FluidState
from ..ops import step as step_mod
from . import mesh as mesh_mod


def shard_state(state: FluidState, mesh) -> FluidState:
    """Place a state pytree with particle arrays sharded over the mesh and
    scalars replicated."""
    axis = mesh.axis_names[0]

    def place(x):
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        spec = P(*([axis] + [None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, state)


def make_sharded_rollout(mesh, cfg: SimConfig):
    """Build a jitted (state, params, num_steps-static) rollout whose bucket
    pipeline is sharded over `mesh`. cfg.grid_dims[0] must be divisible by
    the mesh size."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    if cfg.grid_dims and cfg.grid_dims[0] % n_dev != 0:
        raise ValueError(
            f"grid_dims[0]={cfg.grid_dims[0]} not divisible by mesh size "
            f"{n_dev}")
    constrain = mesh_mod.constrainer(mesh, axis)

    @partial(jax.jit, static_argnums=2, donate_argnums=0)
    def sharded_rollout(state: FluidState, params: SimParams,
                        num_steps: int) -> FluidState:
        def body(s, _):
            return step_mod.step(s, params, cfg, constrain=constrain), None

        state, _ = jax.lax.scan(body, state, None, length=num_steps)
        return state

    return sharded_rollout

"""Particle state as a structure-of-arrays pytree.

The reference packs each particle into an interleaved 80-byte AoS struct
(``FluidParticle``, /root/reference/src/fluid_compute.rs:106-115 and the GPU
mirror assets/simulation.wgsl:69-76). Vectorized passes want wide contiguous
arrays, so state here is SoA: ``(n, dim)`` float arrays for vectors, ``(n,)`` for
scalars. All fields a step produces are retained so a state is a complete
checkpoint (save/restore is a plain pytree serialization, runtime/checkpoint.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

Array = jax.Array


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
class FluidState:
    """SoA particle state.

    ``predicted`` mirrors the reference's ``predicted_position`` used for all
    neighbor searches (simulation.wgsl:139,152,223); densities/pressures are
    the (density, near_density)/(pressure, near_pressure) pairs the reference
    stores as vec2s (simulation.wgsl:73-74). ``step_count`` and ``time``
    track sim progress (drives moving-container kinematics).
    """

    pos: Array           # (n, dim)
    vel: Array           # (n, dim)
    predicted: Array     # (n, dim)
    acc: Array           # (n, dim)
    density: Array       # (n,)
    near_density: Array  # (n,)
    pressure: Array      # (n,)
    near_pressure: Array  # (n,)
    step_count: Array    # () int32
    time: Array          # () float32
    overflow: Array      # () int32 — particles not computed last step
    #                      (bucket overflow beyond the rescue budget;
    #                      0 = exact physics last step)
    overflow_total: Array  # () int64-ish f32 — CUMULATIVE dropped-particle
    #                      steps since init; 0 = every particle got exact
    #                      physics on every step (golden runs assert this)
    ids: Array           # (n,) int32 — persistent particle identity. Row i
    #                      of every per-particle array belongs to particle
    #                      ids[i]. The reference's implicit identity is the
    #                      buffer row (fluid_compute.rs:444-464); here the
    #                      domain-decomposed step moves rows between devices
    #                      (parallel/domain.py), so identity is explicit.
    #                      arange(n) on a single device.

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]


def init_state(positions: Array, velocities: Array | None = None) -> FluidState:
    """Build a fresh state from initial positions.

    Matches ``FluidParticle::make_vec_from_positions``
    (/root/reference/src/fluid_compute.rs:118-129): predicted = position,
    everything else zero.
    """
    positions = jnp.asarray(positions)
    n, dim = positions.shape
    dtype = positions.dtype
    if velocities is None:
        velocities = jnp.zeros((n, dim), dtype)
    # Every field gets its own buffer — aliased leaves would break the
    # donated-argument rollout (`f(donate(a), donate(a))`).
    return FluidState(
        pos=positions,
        vel=jnp.asarray(velocities, dtype),
        predicted=jnp.copy(positions),
        acc=jnp.zeros((n, dim), dtype),
        density=jnp.zeros((n,), dtype),
        near_density=jnp.zeros((n,), dtype),
        pressure=jnp.zeros((n,), dtype),
        near_pressure=jnp.zeros((n,), dtype),
        step_count=jnp.zeros((), jnp.int32),
        time=jnp.zeros((), dtype),
        overflow=jnp.zeros((), jnp.int32),
        overflow_total=jnp.zeros((), jnp.float32),
        ids=jnp.arange(n, dtype=jnp.int32),
    )

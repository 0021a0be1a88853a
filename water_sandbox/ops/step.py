"""The simulation step — composition of all passes into one jittable function.

Mirrors the reference's per-frame 141-dispatch sequence
(/root/reference/src/fluid_compute.rs:309-364; SURVEY.md §3.2):

    hash → sort → cell offsets → density/EOS → pressure+viscosity → integrate

but as *one* traced function XLA fuses end-to-end: the neighbor structure is
one sort + a few scatters, both SPH passes are static-shape masked gathers,
and integrate fuses into the force pass epilogue. There is no host↔device
traffic inside a step and no per-pass dispatch overhead.

``step`` is the unit the runtime jits with donated state buffers;
``rollout`` wraps it in ``lax.scan`` for zero-Python-overhead multi-step runs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.params import KernelCoeffs, SimConfig, SimParams
from ..core.state import FluidState
from . import dense, grid as grid_mod, integrate as integrate_mod


def step(state: FluidState, params: SimParams, cfg: SimConfig,
         constrain=None) -> FluidState:
    """Advance one dt. Pure; jit with static cfg:
    ``jax.jit(step, static_argnums=2)`` (the runtime does this, with donated
    state). ``constrain`` threads a sharding hook into the bucket pipeline
    (see parallel/gspmd.py)."""
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    predicted = state.predicted

    if cfg.neighbor_mode == "dense":
        density, near_density, pressure, near_pressure = dense.density_pass(
            predicted, params, coeffs)
        acc = dense.force_pass(predicted, state.vel, density, near_density,
                               pressure, near_pressure, params, coeffs)
        overflow = jnp.zeros((), jnp.int32)
    elif cfg.neighbor_mode == "bucket_grid":
        density, near_density, pressure, near_pressure, acc, overflow = (
            grid_mod.bucket_sph(predicted, state.vel, params, coeffs, cfg,
                                constrain=constrain, time=state.time))
    elif cfg.neighbor_mode == "hash_grid":
        density, near_density, pressure, near_pressure, acc, overflow = (
            grid_mod.hash_sph(predicted, state.vel, params, coeffs, cfg))
    else:
        raise ValueError(f"unknown neighbor_mode {cfg.neighbor_mode!r}")

    t_new = state.time + params.dt
    pos, vel, predicted = integrate_mod.integrate(
        state.pos, state.vel, acc, params, t_new)

    return FluidState(
        pos=pos,
        vel=vel,
        predicted=predicted,
        acc=acc,
        density=density,
        near_density=near_density,
        pressure=pressure,
        near_pressure=near_pressure,
        step_count=state.step_count + 1,
        time=t_new,
        overflow=overflow,
        overflow_total=state.overflow_total + overflow.astype(jnp.float32),
        ids=state.ids,
    )


@partial(jax.jit, static_argnums=(2, 3), donate_argnums=0)
def rollout(state: FluidState, params: SimParams, cfg: SimConfig,
            num_steps: int) -> FluidState:
    """num_steps of `step` under lax.scan with donated buffers."""
    def body(s, _):
        return step(s, params, cfg), None

    state, _ = jax.lax.scan(body, state, None, length=num_steps)
    return state


@partial(jax.jit, static_argnums=(2, 3, 4))
def trajectory(state: FluidState, params: SimParams, cfg: SimConfig,
               num_steps: int, record_every: int = 1):
    """Rollout that also stacks recorded positions: returns
    (final_state, positions (num_records, n, dim))."""
    if num_steps % record_every:
        raise ValueError(
            f"num_steps={num_steps} not divisible by record_every="
            f"{record_every}; the remainder steps would be silently dropped")

    def body(s, _):
        s2 = jax.lax.fori_loop(
            0, record_every, lambda _, st: step(st, params, cfg), s)
        return s2, s2.pos

    return jax.lax.scan(body, state, None, length=num_steps // record_every)

"""Semi-implicit Euler integration + boundary collision + prediction.

Mirrors the reference ``integrate`` pass
(/root/reference/assets/simulation.wgsl:272-310):

    v += (g + a)·dt;  x += v·dt;
    per-axis AABB clamp with velocity flip ×(-damping);
    predicted = x + v·lookahead

Extensions with no reference counterpart:
  * interaction force field (point attractor/repulsor) folded into the
    acceleration before the velocity update;
  * moving/rotating container — collision is resolved in the box's local
    frame against the *wall-relative* velocity, so a translating or yawing
    box drags the fluid. For a static box this reduces bit-for-bit to the
    reference behavior (R = I, wall velocity = 0).

Everything is written in *axes form* — per-axis lists of arrays — with
explicit multiply-adds instead of matrix products (see _rotate_yaw_axes).
The (n, dim) API wrappers split columns, call the axes form, and restack.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.params import Container, InteractionField, SimParams

Array = jax.Array


def _axes(x: Array) -> list[Array]:
    return [x[:, a] for a in range(x.shape[1])]


def _stack(xs: list[Array]) -> Array:
    return jnp.stack(xs, axis=1)


def field_acceleration_axes(pos: list[Array],
                            field: InteractionField) -> list[Array]:
    """Point repulsor (strength > 0) / attractor (strength < 0) with linear
    falloff over `radius`. Zero strength disables (exactly zero force)."""
    disp = [pos[a] - field.position[a] for a in range(len(pos))]
    r2 = disp[0] * disp[0]
    for a in range(1, len(pos)):
        r2 = r2 + disp[a] * disp[a]
    r = jnp.sqrt(r2)
    safe_r = jnp.where(r > 0.0, r, 1.0)
    falloff = jnp.maximum(0.0, 1.0 - r / field.radius)
    scale = field.strength * falloff
    return [jnp.where(r > 0.0, d / safe_r, 0.0) * scale for d in disp]


def field_acceleration(pos: Array, field: InteractionField) -> Array:
    return _stack(field_acceleration_axes(_axes(pos), field))


def _rotate_yaw_axes(x: list[Array], angle: Array,
                     inverse: bool = False) -> list[Array]:
    """Apply the yaw rotation (about +z in 2-D, +y in 3-D) to per-axis
    arrays with explicit multiply-adds.

    NEVER use `@`/matmul here without ``precision=HIGHEST``: on the GPU a
    default-precision float32 matmul may run on the tensor cores in TF32,
    which keeps 10 mantissa bits and so rounds every position to a
    2^-11-relative grid each step — coincident pairs form (absorbing states
    under the d==0 +y fallback, wgsl:243-248), local density ratchets up and
    the simulation detonates (a reduced-precision rotation did exactly this
    at step ~60 of the 256k scene). The elementwise form stays in full
    float32, and a 3x3 rotation gains nothing from a matrix unit anyway."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    if inverse:
        s = -s
    if len(x) == 2:
        return [c * x[0] - s * x[1], s * x[0] + c * x[1]]
    return [c * x[0] + s * x[2], x[1], -s * x[0] + c * x[2]]


def _rotate_yaw(x: Array, angle: Array, inverse: bool = False) -> Array:
    return _stack(_rotate_yaw_axes(_axes(x), angle, inverse))


def container_at(container: Container, t: Array):
    """Box pose at absolute sim time t: (center, yaw angle)."""
    return (container.center + container.velocity * t,
            container.angle + container.angular_velocity * t)


def collide_container_axes(pos: list[Array], vel: list[Array],
                           container: Container, padding: Array,
                           damping: Array, t: Array):
    """Per-axis clamp + velocity flip (simulation.wgsl:284-306), generalized
    to a box posed at time t. Returns (pos, vel) axes lists."""
    dim = len(pos)
    center, angle = container_at(container, t)

    # Wall velocity at each particle (translation + spin), for relative
    # reflection. Zero for a static container.
    rel = [pos[a] - center[a] for a in range(dim)]
    w = container.angular_velocity
    if dim == 2:
        spin = [w * (-rel[1]), w * rel[0]]
    else:
        # omega = (0, w, 0);  omega x r = (w*r_z, 0, -w*r_x)
        spin = [w * rel[2], jnp.zeros_like(rel[0]), w * (-rel[0])]
    wall_vel = [container.velocity[a] + spin[a] for a in range(dim)]

    # Into the local frame (elementwise rotation — see _rotate_yaw_axes for
    # why this must never be a matmul).
    local_pos = _rotate_yaw_axes(rel, angle, inverse=True)
    local_vel = _rotate_yaw_axes(
        [vel[a] - wall_vel[a] for a in range(dim)], angle, inverse=True)

    lo = -container.half_size + padding
    hi = container.half_size - padding
    for a in range(dim):
        hit = (local_pos[a] < lo[a]) | (local_pos[a] > hi[a])
        local_pos[a] = jnp.clip(local_pos[a], lo[a], hi[a])
        local_vel[a] = jnp.where(hit, local_vel[a] * (-damping),
                                 local_vel[a])

    back_pos = _rotate_yaw_axes(local_pos, angle)
    back_vel = _rotate_yaw_axes(local_vel, angle)
    return ([back_pos[a] + center[a] for a in range(dim)],
            [back_vel[a] + wall_vel[a] for a in range(dim)])


def collide_container(pos: Array, vel: Array, container: Container,
                      padding: Array, damping: Array, t: Array):
    p, v = collide_container_axes(_axes(pos), _axes(vel), container,
                                  padding, damping, t)
    return _stack(p), _stack(v)


def integrate_axes(pos: list[Array], vel: list[Array], acc: list[Array],
                   params: SimParams, t_new: Array):
    """One integration step at absolute time t_new (post-step time), on
    per-axis arrays of any common shape.

    Returns (pos, vel, predicted) axes lists."""
    dim = len(pos)
    fa = field_acceleration_axes(pos, params.field)
    vel = [vel[a] + (params.gravity[a] + acc[a] + fa[a]) * params.dt
           for a in range(dim)]
    # optional speed limiter (params.max_speed > 0): overlap catastrophes
    # (see core/params.py) are bounded instead of cascading to NaN
    speed2 = vel[0] * vel[0]
    for a in range(1, dim):
        speed2 = speed2 + vel[a] * vel[a]
    limit = params.max_speed
    scale = jnp.where(
        (limit > 0.0) & (speed2 > limit * limit),
        limit * jax.lax.rsqrt(jnp.maximum(speed2, 1e-30)), 1.0)
    vel = [v * scale for v in vel]
    pos = [pos[a] + vel[a] * params.dt for a in range(dim)]
    pos, vel = collide_container_axes(pos, vel, params.container,
                                      params.particle_radius,
                                      params.collision_damping, t_new)
    predicted = [pos[a] + vel[a] * params.lookahead for a in range(dim)]
    return pos, vel, predicted


def integrate(pos: Array, vel: Array, acc: Array, params: SimParams,
              t_new: Array):
    """One integration step on (n, dim) rows. Returns (pos, vel, predicted)."""
    p, v, pr = integrate_axes(_axes(pos), _axes(vel), _axes(acc),
                              params, t_new)
    return _stack(p), _stack(v), _stack(pr)

"""Scene definitions and the scene registry.

The reference hard-codes one scene: a 64×32×32 lattice cube of 65,536
particles centered in a 16×9×9 box (/root/reference/src/fluid_compute.rs:15-17,285
via cube_fluid, src/helpers.rs:3-20). Here scenes are first-class: a scene
builds (SimConfig, SimParams, FluidState) and the registry covers a ladder of
sizes (4k → 16k → 64k → 256k → 1M+).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..core.params import (Container, InteractionField, SimConfig, SimParams,
                           DEFAULT_PARTICLE_RADIUS, DEFAULT_SMOOTHING_RADIUS)
from ..core.state import FluidState, init_state
from ..ops import hashing


def cube_fluid(ni: int, nj: int, nk: int | None = None,
               particle_radius: float = DEFAULT_PARTICLE_RADIUS,
               center=None, dtype=jnp.float32):
    """Axis-aligned lattice of ni·nj(·nk) points at 2r spacing, centered at
    the origin (or `center`). Port of cube_fluid
    (/root/reference/src/helpers.rs:3-20); nk=None gives the 2-D variant.

    Built with numpy (host) — scene construction is init-time, not hot path.
    """
    dims = [ni, nj] if nk is None else [ni, nj, nk]
    r = particle_radius
    half = np.array(dims, np.float32) * r
    offset = r - half
    axes = [np.arange(d, dtype=np.float32) * (2 * r) for d in dims]
    grids = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.reshape(-1) for g in grids], axis=-1) + offset
    if center is not None:
        pts = pts + np.asarray(center, np.float32)
    return jnp.asarray(pts, dtype)


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    description: str
    build: Callable[[], tuple]  # () -> (SimConfig, SimParams, FluidState)


_REGISTRY: dict[str, Scene] = {}


def register(name: str, description: str):
    def deco(fn):
        _REGISTRY[name] = Scene(name, description, fn)
        return fn
    return deco


def get(name: str) -> Scene:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scene {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def _grid_dims_for(container_size, h=DEFAULT_SMOOTHING_RADIUS):
    return hashing.default_grid_dims(container_size, h)


def build(name: str, **overrides):
    """Build a scene; overrides replace SimConfig fields (e.g.
    neighbor_mode='dense')."""
    cfg, params, state = get(name).build()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, params, state


@register("reference-cube",
          "the reference scene: 64x32x32 = 65,536 particle cube in a "
          "16x9x9 box (fluid_compute.rs:15-17,285)")
def _reference_cube():
    pts = cube_fluid(64, 32, 32)
    cfg = SimConfig(n=pts.shape[0], dim=3,
                    grid_dims=_grid_dims_for((16.0, 9.0, 9.0)),
                    cell_capacity=24, rescue_capacity=2048)
    params = SimParams.create(dim=3)
    return cfg, params, init_state(pts)


def _cube_for_n(target_n: int, dim: int, container_size, aspect=(2.0, 1.0, 1.0)):
    """Lattice dims whose product is ~target_n with the given aspect."""
    aspect = aspect[:dim]
    scale = (target_n / math.prod(aspect)) ** (1.0 / dim)
    dims = [max(1, round(a * scale)) for a in aspect]
    return dims


def lattice_rest_density(spacing: float, h: float, dim: int) -> float:
    """Rest density of an infinite lattice at `spacing` under the density
    kernel — used to pick a physically-settled target_density for new scenes
    (the reference's target of 10 deliberately makes its cube explode and
    settle; see src/fluid_compute.rs:23)."""
    from ..core.params import KernelCoeffs
    reach = int(math.ceil(h / spacing))
    axes = [np.arange(-reach, reach + 1) * spacing] * dim
    grids = np.meshgrid(*axes, indexing="ij")
    d = np.sqrt(sum(g * g for g in grids)).reshape(-1)
    d = d[d <= h]
    k = KernelCoeffs.from_radius(jnp.asarray(h, jnp.float32), dim)
    v = h - d
    return float(np.sum(v * v) * float(k.pow2))


@register("dam-break-2d-4k",
          "2-D dam break, ~4k particles, gravity + "
          "pressure (viscosity off)")
def _dam_break_2d_4k():
    size = (16.0, 9.0)
    r = 0.05
    ni, nj = 50, 80  # 4000 particles, 5 m x 8 m column
    pts = cube_fluid(ni, nj, None, particle_radius=r,
                     center=(-8.0 + ni * r + 0.1, -4.5 + nj * r + 0.1))
    # cap 24: the settled pool compresses ~1.3x under the soft default EOS
    # and floor cells exceed 16 (12 particles dropped in a 1k-step run)
    cfg = SimConfig(n=pts.shape[0], dim=2, grid_dims=_grid_dims_for(size),
                    cell_capacity=24, rescue_capacity=1024)
    params = SimParams.create(
        dim=2, container=Container.create((0.0, 0.0), size),
        particle_radius=r, viscosity_strength=0.0,
        target_density=lattice_rest_density(2 * r, DEFAULT_SMOOTHING_RADIUS, 2))
    return cfg, params, init_state(pts)


@register("interactive-2d-16k",
          "2-D, ~16k particles, viscosity + interaction "
          "force field (NEW feature, no reference counterpart)")
def _interactive_2d_16k():
    # Stiff-EOS recipe (see moving-container-256k scene-design notes): the
    # settled pool here is ~6.7 m deep, and at the soft reference EOS
    # (k = 22, scale height ~2.2 m) the floor compresses ~12x — no fixed
    # cell capacity holds that (measured overflow_total > 1M over 200
    # steps at cap 16). k = 100 bounds compression to ~2x (cap 32 holds the
    # floor + wall layers); CFL then needs dt = 1/120.
    size = (24.0, 12.0)
    r = 0.05
    pts = cube_fluid(200, 80, None, particle_radius=r,
                     center=(0.0, -6.0 + 80 * r + 0.1))  # 16,000
    cfg = SimConfig(n=pts.shape[0], dim=2, grid_dims=_grid_dims_for(size),
                    cell_capacity=32, rescue_capacity=2048)
    params = SimParams.create(
        dim=2, container=Container.create((0.0, 0.0), size),
        particle_radius=r,
        pressure_scalar=100.0,
        dt=1.0 / 120.0,
        target_density=lattice_rest_density(2 * r, DEFAULT_SMOOTHING_RADIUS, 2),
        field=InteractionField.create((0.0, 0.0), strength=15.0, radius=2.0))
    return cfg, params, init_state(pts)


@register("sort-stress-64k",
          "64k particles, neighbor-pipeline stress "
          "(the reference's own particle count)")
def _sort_stress_64k():
    pts = cube_fluid(64, 32, 32)
    cfg = SimConfig(n=pts.shape[0], dim=3,
                    grid_dims=_grid_dims_for((16.0, 9.0, 9.0)),
                    cell_capacity=24, chunk=4096, rescue_capacity=2048)
    params = SimParams.create(dim=3)
    return cfg, params, init_state(pts)


@register("moving-container-256k",
          "256k particles with a translating+yawing "
          "container (NEW feature — reference container is static)")
def _moving_container_256k():
    """Reference-faithful physics at 4x the particle count.

    Scene-design notes (benchmarks/occupancy_256k.py measures the cell
    occupancy): the reference's EOS (k=22) is an isothermal gas with pressure scale
    height k/g ~ 2.2 m, so pool depth sets the bottom-cell compression
    exp(depth/2.2). The reference's own pool is ~3.6 m deep (65k particles
    over a 16x9 footprint -> ~5x compression); a deep-pool 256k variant
    compresses 80x and NO fixed cell capacity can hold it. Stiffening the
    EOS instead (k=800, target = lattice rest) bounds compression but puts
    free surfaces in strong tension -> the box fills with 10 m/s mist.
    The honest scaling is the reference's own geometry: a shallow wide
    pool (~4.4 m deep here) with the reference's exact solver constants,
    including dt = 1/60."""
    size = (40.0, 10.0, 14.0)
    pts = cube_fluid(198, 24, 56, center=(0.0, -2.0, 0.0))  # 266,112
    # Cell capacity 16: the peak per-cell occupancy over a full 1k-step
    # trajectory — fresh lattice, transient slosh, settled drag — is 11
    # (settled maximum 6), a margin of 5 below the cap, with
    # overflow_total == 0. The exact rescue sweep still covers any
    # params-retuned state beyond capacity.
    # Kinematics chosen so the wall sweep stays well below the EOS sound
    # speed sqrt(22) ~ 4.7 m/s.
    # yaw 0.02: a fast-yawing long box scoops its corners — corner cells
    # reach 141 particles at yaw 0.05 even under exact physics (the clamp
    # holds them against the pressure response), which keeps the
    # O(rescue*n) exact fallback hot every step. At yaw 0.02 the corner
    # sweep (0.42 m/s) stays far below the EOS sound speed and corners stay
    # under capacity; rescue is then a transient-only safety net.
    # CONTAINER-FRAME grid: cell keys are computed in the yawing box's body
    # frame (ops/hashing.py::key_coords), so the static grid covers only the
    # box interior — (162, 32, 58) body cells — instead of the swept world
    # AABB a world-frame grid needs ((168, 44, 80); at yaw angle a the world
    # footprint grows to (40cos a + 14sin a) x (40sin a + 14cos a) and
    # starts clamping past yaw 0.16 rad ~ step 950): 300,672 cells instead
    # of 591,360. Physics is exact either way (isometric keys +
    # world-coordinate distance filter), trajectories differ at
    # float-reassociation level. Body-frame fluid extents over the full
    # 1k-step trajectory: (159.2, 30.2, 55.2) cells — margins (2.8, 1.8,
    # 2.8) under the dims; excursions past the dims would clamp (exact,
    # monotone non-expansive), never drop.
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(162, 32, 58),
                    grid_frame="container",
                    cell_capacity=16, chunk=8192, rescue_capacity=16384)
    # k=100 (reference formula, stiffer constant — it's the HUD-tunable
    # pressure scalar): pressure stays positive everywhere (target 10 <<
    # any real density, like the reference), the scale height k/g ~ 10 m
    # keeps pool compression ~1.5x, and the dragging-wall contact layer
    # stays ~4.5x thinner than at k=22 (bounded by cap 32). CFL needs
    # c*dt = sqrt(100)/120 = 0.083 << h — two sub-steps per 60 Hz frame.
    params = SimParams.create(
        dim=3,
        pressure_scalar=100.0,
        dt=1.0 / 120.0,
        container=Container.create((0.0, 0.0, 0.0), size,
                                   velocity=(0.3, 0.0, 0.0),
                                   angular_velocity=0.02))
    return cfg, params, init_state(pts)


@register("sharded-1m",
          "~1M particles for multi-chip domain "
          "decomposition (parallel/domain.py)")
def _sharded_1m():
    # shallow-pool geometry for bounded occupancy at the reference EOS
    # (see moving-container-256k); grid x = 408 divides by 4 and 8 for the mesh
    size = (100.0, 10.0, 18.0)
    pts = cube_fluid(498, 24, 85, center=(0.0, -2.0, 0.0))  # 1,015,920
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(408, 44, 76),
                    cell_capacity=32, chunk=8192, rescue_capacity=16384)
    params = SimParams.create(
        dim=3,
        pressure_scalar=100.0,  # see moving-container-256k
        dt=1.0 / 120.0,
        container=Container.create((0.0, 0.0, 0.0), size))
    return cfg, params, init_state(pts)


@register("mini-3d",
          "tiny 3-D cube for tests and smoke runs (512 particles)")
def _mini_3d():
    pts = cube_fluid(8, 8, 8)
    cfg = SimConfig(n=pts.shape[0], dim=3,
                    grid_dims=_grid_dims_for((16.0, 9.0, 9.0)),
                    cell_capacity=16, chunk=256)
    params = SimParams.create(dim=3)
    return cfg, params, init_state(pts)

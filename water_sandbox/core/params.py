"""Simulation parameters — the single source of truth for all physics constants.

The reference scatters its constants across host Rust consts and WGSL shader
consts (and lets them drift: host ``PARTICLE_LOOKAHEAD_SCALAR = 1/60``
(/root/reference/src/fluid_compute.rs:27) vs shader ``LOOKAHEAD_FACTOR = 1/50``
(/root/reference/assets/simulation.wgsl:3)). Here everything lives in one
pytree, :class:`SimParams`, which is a *runtime* jit argument — so every field
is tunable between steps without recompilation (subsuming the reference HUD
keymap, /root/reference/src/hud.rs:130-165).

Static compilation-shaping facts (particle count, spatial dimension, grid
resolution, cell capacity) live in :class:`SimConfig`, a hashable frozen
dataclass passed as a static argument.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

Array = jax.Array

# Defaults mirror the reference solver constants
# (/root/reference/src/fluid_compute.rs:20-27, src/gravity.rs:6,
#  src/fluid_container.rs:8-9, assets/simulation.wgsl:3-4).
DEFAULT_PARTICLE_RADIUS = 0.1
DEFAULT_COLLISION_DAMPING = 0.95
DEFAULT_SMOOTHING_RADIUS = 0.25
DEFAULT_TARGET_DENSITY = 10.0
DEFAULT_PRESSURE_SCALAR = 22.0
DEFAULT_NEAR_PRESSURE_SCALAR = 2.0
DEFAULT_VISCOSITY_STRENGTH = 0.1
DEFAULT_DT = 1.0 / 60.0
DEFAULT_LOOKAHEAD = 1.0 / 50.0
DEFAULT_GRAVITY_Y = -9.8
DEFAULT_CONTAINER_SIZE = (16.0, 9.0, 9.0)
DENSITY_PADDING = 1e-5


def _pytree_dataclass(cls):
    """Register a frozen dataclass whose fields are all jax-traceable leaves."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
class Container:
    """Axis-aligned box boundary.

    Mirrors ``FluidContainer`` (/root/reference/src/fluid_container.rs:25-51):
    stored as center + size; collision uses the extent shrunk by the particle
    radius (``get_ext(padding)``, fluid_container.rs:42-51).

    New (no reference counterpart): the box may translate
    with ``velocity`` and yaw about its center at ``angular_velocity`` rad/s
    (about +z in 2D, +y in 3D). Collision response is computed in the
    container's local frame, so a moving box drags fluid correctly.
    """

    center: Array        # (dim,)
    half_size: Array     # (dim,)
    velocity: Array      # (dim,) — box translation per second
    angular_velocity: Array  # () — yaw rate, rad/s
    angle: Array         # () — current yaw

    @staticmethod
    def create(center=(0.0, 0.0, 0.0), size=DEFAULT_CONTAINER_SIZE,
               velocity=None, angular_velocity=0.0, angle=0.0,
               dtype=jnp.float32) -> "Container":
        center = jnp.asarray(center, dtype)
        size = jnp.asarray(size, dtype)
        if velocity is None:
            velocity = jnp.zeros_like(center)
        else:
            velocity = jnp.asarray(velocity, dtype)
        return Container(
            center=center,
            half_size=size / 2.0,
            velocity=velocity,
            angular_velocity=jnp.asarray(angular_velocity, dtype),
            angle=jnp.asarray(angle, dtype),
        )

    @property
    def dim(self) -> int:
        return self.center.shape[-1]

    def ext(self, padding: Array | float):
        """(ext_min, ext_max) shrunk by `padding`, in the local (unrotated)
        frame centered on `center`. Mirrors get_ext
        (/root/reference/src/fluid_container.rs:42-51)."""
        ext_min = self.center - self.half_size + padding
        ext_max = self.center + self.half_size - padding
        return ext_min, ext_max

    @property
    def is_moving(self) -> Array:
        v2 = jnp.sum(self.velocity**2) + self.angular_velocity**2
        return v2 > 0


@_pytree_dataclass
class InteractionField:
    """Point attractor/repulsor force field (mouse-interaction analogue).

    NEW feature with no reference counterpart (the reference's field.rs is
    background color/lighting only — /root/reference/src/field.rs:9-21; see
    SURVEY.md §6 caveats). Force on a particle at distance r < radius from
    `position` is `strength * (1 - r/radius)` along the (outward for
    strength>0) radial direction, blended against gravity like common SPH
    sandbox interaction forces.
    """

    position: Array   # (dim,)
    strength: Array   # () — >0 repels, <0 attracts, 0 disables
    radius: Array     # ()

    @staticmethod
    def inactive(dim: int, dtype=jnp.float32) -> "InteractionField":
        return InteractionField(
            position=jnp.zeros((dim,), dtype),
            strength=jnp.asarray(0.0, dtype),
            radius=jnp.asarray(1.0, dtype),
        )

    @staticmethod
    def create(position, strength, radius, dtype=jnp.float32) -> "InteractionField":
        return InteractionField(
            position=jnp.asarray(position, dtype),
            strength=jnp.asarray(strength, dtype),
            radius=jnp.asarray(radius, dtype),
        )


@_pytree_dataclass
class SimParams:
    """All runtime-tunable physics parameters (jit argument, pytree).

    Scalar fields mirror ``FluidStaticProps``
    (/root/reference/src/fluid_compute.rs:41-51) plus gravity
    (src/gravity.rs:9-13), the container, the prediction lookahead
    (assets/simulation.wgsl:3) and particle radius (collision padding).
    """

    dt: Array
    collision_damping: Array
    smoothing_radius: Array
    target_density: Array
    pressure_scalar: Array
    near_pressure_scalar: Array
    viscosity_strength: Array
    lookahead: Array
    particle_radius: Array
    gravity: Array               # (dim,)
    # Optional speed limiter (0 = off, the reference-faithful default): an
    # explicit integrator can overshoot catastrophically when geometry
    # compresses particles into overlap (e.g. a fast-swept container wall
    # plowing transonically vs the EOS sound speed sqrt(k)); clamping |v|
    # bounds the damage to one cell per step instead of a NaN cascade.
    max_speed: Array
    container: Container
    field: InteractionField

    @staticmethod
    def create(
        dim: int = 3,
        dt: float = DEFAULT_DT,
        collision_damping: float = DEFAULT_COLLISION_DAMPING,
        smoothing_radius: float = DEFAULT_SMOOTHING_RADIUS,
        target_density: float = DEFAULT_TARGET_DENSITY,
        pressure_scalar: float = DEFAULT_PRESSURE_SCALAR,
        near_pressure_scalar: float = DEFAULT_NEAR_PRESSURE_SCALAR,
        viscosity_strength: float = DEFAULT_VISCOSITY_STRENGTH,
        lookahead: float = DEFAULT_LOOKAHEAD,
        particle_radius: float = DEFAULT_PARTICLE_RADIUS,
        max_speed: float = 0.0,
        gravity=None,
        container: Container | None = None,
        field: InteractionField | None = None,
        dtype=jnp.float32,
    ) -> "SimParams":
        if gravity is None:
            gravity = [0.0] * dim
            gravity[1] = DEFAULT_GRAVITY_Y
        gravity = jnp.asarray(gravity, dtype)
        if container is None:
            size = DEFAULT_CONTAINER_SIZE[:dim]
            container = Container.create(center=[0.0] * dim, size=size, dtype=dtype)
        if field is None:
            field = InteractionField.inactive(dim, dtype)
        as_scalar = lambda x: jnp.asarray(x, dtype)
        return SimParams(
            dt=as_scalar(dt),
            collision_damping=as_scalar(collision_damping),
            smoothing_radius=as_scalar(smoothing_radius),
            target_density=as_scalar(target_density),
            pressure_scalar=as_scalar(pressure_scalar),
            near_pressure_scalar=as_scalar(near_pressure_scalar),
            viscosity_strength=as_scalar(viscosity_strength),
            lookahead=as_scalar(lookahead),
            particle_radius=as_scalar(particle_radius),
            max_speed=as_scalar(max_speed),
            gravity=gravity,
            container=container,
            field=field,
        )

    @property
    def dim(self) -> int:
        return self.gravity.shape[-1]

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **{
            k: (jnp.asarray(v, self.dt.dtype) if not isinstance(
                v, (Container, InteractionField, jax.Array)) else v)
            for k, v in kw.items()
        })


@_pytree_dataclass
class KernelCoeffs:
    """Smoothing-kernel normalization constants, derived from the smoothing
    radius inside jit (so radius changes need no recompile).

    3-D formulas are exactly ``SmoothingKernel::get_smoothing_kernel``
    (/root/reference/src/fluid_compute.rs:55-63); 2-D are the standard
    2-D normalizations of the same kernel shapes (spiky², spiky³, poly6).
    """

    pow2: Array        # density kernel   (h-d)^2
    pow2_der: Array    # its derivative   (d-h) * pow2_der
    pow3: Array        # near-density     (h-d)^3
    pow3_der: Array    # its derivative   (d-h)^2 * pow3_der
    spikey_pow3: Array  # viscosity/poly6 (h^2-d^2)^3

    @staticmethod
    def from_radius(h: Array, dim: int) -> "KernelCoeffs":
        pi = math.pi
        if dim == 3:
            return KernelCoeffs(
                pow2=15.0 / (2.0 * pi * h**5),
                pow2_der=15.0 / (pi * h**5),
                pow3=15.0 / (pi * h**6),
                pow3_der=45.0 / (pi * h**6),
                spikey_pow3=315.0 / (64.0 * pi * h**9),
            )
        elif dim == 2:
            return KernelCoeffs(
                pow2=6.0 / (pi * h**4),
                pow2_der=12.0 / (pi * h**4),
                pow3=10.0 / (pi * h**5),
                pow3_der=30.0 / (pi * h**5),
                spikey_pow3=4.0 / (pi * h**8),
            )
        raise ValueError(f"dim must be 2 or 3, got {dim}")


NEIGHBOR_MODES = ("dense", "hash_grid", "bucket_grid")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static (hashable) compilation-shaping configuration.

    Changing any of these triggers recompilation; changing SimParams does not.

    - ``n``: particle count. Unlike the reference (power-of-two only, FIXME at
      /root/reference/src/fluid_compute.rs:15) any n is supported — the grid
      pipeline pads with sentinel keys.
    - ``neighbor_mode``: which neighbor pipeline the step uses:
        * "bucket_grid" — the default: collision-free bounded grid with
                          fixed-capacity cell buckets (ops/grid.py)
        * "dense"       — O(N²) all-pairs oracle (ground truth, small n)
        * "hash_grid"   — exact emulation of the reference's hashed cell
                          table, incl. its hash-collision multi-count
                          semantics (simulation.wgsl:121-128,162-183)
    - ``grid_dims``: cells per axis for the bounded grid. Must satisfy
      cell_size = container_size/grid_dims >= smoothing_radius at runtime.
    - ``cell_capacity``: max particles per cell bucket (overflow drops with
      accounting — see ops/grid.py).
    - ``chunk``: particles per chunk in the chunked sweeps (hash_grid passes
      and the overflow rescue; a memory/throughput tradeoff).
    """

    n: int
    dim: int = 3
    neighbor_mode: str = "bucket_grid"
    grid_dims: tuple = ()        # required for bucket_grid; see __post_init__
    cell_capacity: int = 16
    hash_table_size: int = 0     # 0 = n (the reference uses n)
    max_run: int = 64            # hash_grid: max contiguous same-hash run walked
    chunk: int = 2048
    dtype: str = "float32"
    # Exact physics for cell-capacity overflow (ops/rescue.py): up to this
    # many dropped particles per step get a dense fallback pass, and their
    # pair contributions are injected back into resident particles. 0
    # disables (overflow stays dropped-and-counted). Only steps that
    # actually overflow pay the sweep (lax.cond).
    rescue_capacity: int = 0
    # Frame the bucket-grid cell keys are computed in
    # (ops/hashing.py::key_coords):
    #   "world"     — raw predicted positions (default).
    #   "container" — the container's body frame. For a translating/yawing
    #                 box the static grid then needs to cover only the box
    #                 interior, not the swept world AABB. Exact physics
    #                 either way (isometric keys; the distance filter runs
    #                 on stored world coordinates); trajectories differ at
    #                 float-reassociation level.
    # Single-device only: the domain-decomposed multi-device step shards
    # x-slabs of a static world grid.
    grid_frame: str = "world"

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        if self.grid_frame not in ("world", "container"):
            raise ValueError(f"bad grid_frame {self.grid_frame!r}")
        if self.neighbor_mode not in NEIGHBOR_MODES:
            raise ValueError(
                f"bad neighbor_mode {self.neighbor_mode!r}; choose one of "
                f"{NEIGHBOR_MODES} ('bucket_grid' is the production "
                "pipeline)")
        if self.neighbor_mode == "bucket_grid":
            # grid_dims shapes the compiled program, so it cannot be derived
            # from the (runtime, traced) container inside jit — it must be
            # chosen up front: ops.hashing.default_grid_dims(container_size, h)
            if len(self.grid_dims) != self.dim:
                raise ValueError(
                    f"neighbor_mode={self.neighbor_mode!r} needs grid_dims of "
                    f"length dim={self.dim} (got {self.grid_dims!r}); derive "
                    "them with hashing.default_grid_dims(container_size, "
                    "smoothing_radius)")
            if any(d < 3 for d in self.grid_dims):
                raise ValueError(
                    f"grid_dims must each be >= 3, got {self.grid_dims!r}")

    @property
    def table_size(self) -> int:
        return self.hash_table_size or self.n

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    @property
    def num_neighbor_cells(self) -> int:
        return 3**self.dim

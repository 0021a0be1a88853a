"""On-device density-field rasterization for rendering.

The reference renders particles as icosphere meshes and hints at a
velocity-color field it never finished (commented out,
src/fluid_compute.rs:489-502). Here the device produces render-ready fields
directly: a density (or speed) raster splatted onto a regular image grid with
one scatter-add — no per-particle host work. 2-D scenes raster the plane;
3-D scenes raster an axis-aligned slice or a column-sum projection.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array


@partial(jax.jit, static_argnums=(3, 4))
def raster2d(pos: Array, values: Array, bounds, width: int, height: int):
    """Splat per-particle `values` (n,) onto a (height, width) image.

    bounds = (min_xy, max_xy) arrays of shape (2,). Bilinear splat (each
    particle feeds its 4 surrounding pixels) for smooth fields."""
    lo, hi = bounds
    extent = hi - lo
    uv = (pos[:, :2] - lo) / extent * jnp.asarray(
        [width - 1, height - 1], pos.dtype)
    x0 = jnp.floor(uv[:, 0]).astype(jnp.int32)
    y0 = jnp.floor(uv[:, 1]).astype(jnp.int32)
    fx = uv[:, 0] - x0
    fy = uv[:, 1] - y0

    img = jnp.zeros((height, width), pos.dtype)
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi = jnp.clip(x0 + dx, 0, width - 1)
        yi = jnp.clip(y0 + dy, 0, height - 1)
        img = img.at[yi, xi].add(values * w)
    return img


def density_image(state, params, width: int = 256, height: int = 144,
                  values=None, z_slab: float | None = None):
    """Raster the particle density field over the container footprint.

    3-D: restrict to a slab |z| < z_slab (default: full projection)."""
    c = params.container
    lo = (c.center - c.half_size)[:2]
    hi = (c.center + c.half_size)[:2]
    pos = state.pos
    vals = state.density if values is None else values
    if pos.shape[1] == 3 and z_slab is not None:
        w = (jnp.abs(pos[:, 2] - c.center[2]) < z_slab).astype(vals.dtype)
        vals = vals * w
    return raster2d(pos, vals, (lo, hi), width, height)


def speed_image(state, params, width: int = 256, height: int = 144):
    """The velocity-magnitude field the reference's commented-out color
    system wanted (src/fluid_compute.rs:489-502)."""
    speed = jnp.sqrt(jnp.sum(state.vel**2, axis=1))
    return density_image(state, params, width, height, values=speed)


def ascii_preview(img, levels: str = " .:-=+*#%@") -> str:
    """Terminal heat map — the zero-dependency HUD."""
    import numpy as np
    a = np.asarray(img)
    if a.max() > 0:
        a = a / a.max()
    idx = (a * (len(levels) - 1)).astype(int)
    return "\n".join("".join(levels[v] for v in row) for row in idx[::-1])

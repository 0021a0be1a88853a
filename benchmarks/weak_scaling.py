"""Weak-scaling harness for the domain-decomposed step.

Runs the shard_map + ppermute domain rollout (parallel/domain.py) over
meshes of 1/2/4/8 devices with particle count and grid length scaled
proportionally (fixed work per device), and prints a scaling table.

On a virtual CPU mesh (--cpu) the numbers measure correctness and relative
scan/collective overhead only; without --cpu it runs on the machine's GPUs.

    python benchmarks/weak_scaling.py --devices 1 2 4 --per-device 4096
    python benchmarks/weak_scaling.py --cpu --devices 1 2 4 8 \
        --per-device 4096 --steps 10
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force an 8-virtual-device CPU mesh")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--per-device", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dim", type=int, default=3)
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={max(args.devices)}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from water_sandbox.core.params import Container, SimConfig, SimParams
    from water_sandbox.core.state import init_state
    from water_sandbox.models.scenes import (cube_fluid,
                                                 lattice_rest_density)
    from water_sandbox.ops import hashing
    from water_sandbox.parallel import domain
    from water_sandbox.runtime.distributed import DistributedSimulation

    rows = []
    for ndev in args.devices:
        if ndev > len(jax.devices()):
            print(f"# skip ndev={ndev}: only {len(jax.devices())} devices")
            continue
        # per-device slab of fixed size: container x-extent grows with ndev
        slab_x = 8.0
        size = [slab_x * ndev, 9.0, 9.0][: args.dim]
        h = 0.25
        # lattice sized for per_device particles per slab
        import math
        per = args.per_device * ndev
        aspect = [size[0]] + [s * 0.5 for s in size[1:]]
        scale = (per / math.prod(aspect)) ** (1.0 / args.dim)
        dims = [max(2, round(a * scale)) for a in aspect]
        pts = cube_fluid(*dims if args.dim == 3 else (*dims, None),
                         particle_radius=0.1)
        n = pts.shape[0]

        grid_dims = hashing.default_grid_dims(size, h)
        # grid x must divide by ndev
        gx = -(-grid_dims[0] // ndev) * ndev
        grid_dims = (gx,) + grid_dims[1:]
        cfg = SimConfig(n=n, dim=args.dim, grid_dims=grid_dims,
                        cell_capacity=16)
        params = SimParams.create(
            dim=args.dim,
            container=Container.create([0.0] * args.dim, size),
            target_density=lattice_rest_density(0.2, h, args.dim),
            pressure_scalar=500.0)

        mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("x",))
        sim = DistributedSimulation(cfg, params, init_state(pts), mesh=mesh,
                                    slack=3.0)
        sim.run(2)  # warm both chunk programs
        np.asarray(sim.state.pos)
        t0 = time.perf_counter()
        sim.run(args.steps)
        np.asarray(sim.state.pos)
        wall = time.perf_counter() - t0
        rate = n * args.steps / wall
        rows.append({
            "devices": ndev, "n": n, "steps": args.steps,
            "wall_s": round(wall, 3),
            "particle_steps_per_s": round(rate, 1),
            "per_device_rate": round(rate / ndev, 1),
            "lost": sim.lost_total,
        })
        print(json.dumps(rows[-1]), flush=True)

    if rows:
        base = rows[0]["per_device_rate"]
        print("\n# weak scaling (per-device rate vs 1-device)")
        for r in rows:
            eff = r["per_device_rate"] / base if base else 0.0
            print(f"devices={r['devices']:2d}  n={r['n']:8d}  "
                  f"rate={r['particle_steps_per_s']:12.0f}  "
                  f"per-dev={r['per_device_rate']:12.0f}  eff={eff:5.2f}")
    out = {"rows": rows, "backend": jax.default_backend()}
    with open("benchmarks/weak_scaling_results.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

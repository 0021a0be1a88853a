"""Measure settled-state cell occupancy + step time for moving-container-256k.

Drives the overflow-rescue design: is overflow at a given cap a wall-sheet
pileup that a larger capacity absorbs, or an EOS collapse that no capacity
fixes?

    python benchmarks/occupancy_256k.py [--steps 400]
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--scene", default="moving-container-256k")
    ap.add_argument("--mode", default=None, help="neighbor_mode override")
    ap.add_argument("--tune", default=None,
                    help="JSON dict of SimParams overrides, e.g. "
                         '\'{"viscosity_strength": 0.4}\'')
    ap.add_argument("--rescue", type=int, default=None,
                    help="rescue_capacity override")
    ap.add_argument("--cap", type=int, default=None,
                    help="cell_capacity override")
    args = ap.parse_args()

    import water_sandbox as wst
    from water_sandbox.ops import hashing

    overrides = {"neighbor_mode": args.mode} if args.mode else {}
    if args.rescue is not None:
        overrides["rescue_capacity"] = args.rescue
    if args.cap is not None:
        overrides["cell_capacity"] = args.cap
    sim = wst.Simulation.from_scene(args.scene, **overrides)
    if args.tune:
        sim.tune(**json.loads(args.tune))
    print(f"n={sim.cfg.n} grid={sim.cfg.grid_dims} cap={sim.cfg.cell_capacity}",
          flush=True)

    def occupancy_hist(tag):
        pred = sim.state.predicted
        h = sim.params.smoothing_radius
        origin = hashing.grid_origin(pred, h)
        _, cid = hashing.bounded_cell_ids(pred, h, origin,
                                          sim.cfg.grid_dims)
        import math
        nc = math.prod(sim.cfg.grid_dims)
        counts = jnp.zeros((nc,), jnp.int32).at[cid].add(1)
        counts = np.asarray(counts)
        occ = counts[counts > 0]
        cap = sim.cfg.cell_capacity
        over = counts - cap
        out = {
            "tag": tag,
            "step": int(sim.state.step_count),
            "occupied_cells": int(occ.size),
            "mean_occ": round(float(occ.mean()), 2),
            "p50": int(np.percentile(occ, 50)),
            "p90": int(np.percentile(occ, 90)),
            "p99": int(np.percentile(occ, 99)),
            "p999": int(np.percentile(occ, 99.9)),
            "max": int(occ.max()),
            "cells_over_cap": int((counts > cap).sum()),
            "particles_over_cap": int(over[over > 0].sum()),
            "over_if_cap": {c: int(np.maximum(counts - c, 0).sum())
                            for c in (16, 24, 32, 40, 48, 64)},
            "overflow_counter": int(jax.device_get(sim.state.overflow)),
        }
        print(json.dumps(out), flush=True)
        return out

    results = [occupancy_hist("init")]

    done = 0
    while done < args.steps:
        sim.run(min(50, args.steps - done))
        done += 50
        np.asarray(sim.state.pos)
        print(f"step {done} ke={float(0.5*jnp.sum(sim.state.vel**2)):.1f} "
              f"unrescued_now={int(sim.state.overflow)} "
              f"dropped_total={float(sim.state.overflow_total):.0f}",
              flush=True)
    results.append(occupancy_hist("settled"))

    # settled-state step time, on the device JAX chose
    jax.block_until_ready(sim.state)
    t0 = time.perf_counter()
    sim.run(30)
    jax.block_until_ready(sim.state)
    wall = time.perf_counter() - t0
    results.append({"settled_ms_per_step": round(wall / 30 * 1e3, 2),
                    "settled_psps": round(30 * sim.cfg.n / wall, 0),
                    "device_kind": jax.devices()[0].device_kind})
    print(json.dumps(results[-1]), flush=True)

    with open("benchmarks/occupancy_256k_results.json", "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

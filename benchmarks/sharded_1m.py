"""The 1,015,920-particle `sharded-1m` scene stepping end-to-end through
DistributedSimulation (shard_map + ppermute halo exchange + migration) at
the real scene shape, with per-device counts, lost == 0, and cumulative
overflow recorded. `python chip_smoke.py --four-cards` is the checked
four-GPU run of the same scene; this script records counts and times.

    python benchmarks/sharded_1m.py --devices 4 --steps 10   # GPUs
    python benchmarks/sharded_1m.py --cpu --steps 10         # virtual CPU mesh
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force a virtual CPU mesh of --devices devices")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    # with a bulk +x drift the per-device counts change, so `lost == 0`
    # certifies real cross-device migration AT SIZE (the static-container
    # run exercises halo exchange and shapes, but its counts are
    # stationary). Writes a separate artifact:
    # sharded_1m_migration_results.json.
    ap.add_argument("--bulk-velocity", type=float, default=0.0,
                    help="initial +x fluid velocity (m/s); forces "
                    "cross-device migration")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import numpy as np

    from water_sandbox.runtime.distributed import DistributedSimulation

    t0 = time.perf_counter()
    if args.bulk_velocity:
        import dataclasses

        import jax.numpy as jnp

        from water_sandbox.models import scenes as scene_registry

        cfg, params, state = scene_registry.build("sharded-1m")
        vel = jnp.zeros_like(state.vel).at[:, 0].set(args.bulk_velocity)
        state = dataclasses.replace(
            state, vel=vel,
            predicted=state.pos + vel * params.lookahead)
        sim = DistributedSimulation(cfg, params, state,
                                    n_devices=args.devices, slack=1.5,
                                    name="sharded-1m")
    else:
        sim = DistributedSimulation.from_scene("sharded-1m",
                                               n_devices=args.devices,
                                               slack=1.5)
    counts0 = np.asarray(sim.active).reshape(
        args.devices, -1).sum(axis=1).astype(int).tolist()
    build_s = time.perf_counter() - t0

    sim.run(1)  # compile + step 1
    compile_s = time.perf_counter() - t0 - build_s
    t1 = time.perf_counter()
    sim.run(args.steps - 1)
    wall = time.perf_counter() - t1
    st = sim.stats()

    ovf = float(np.asarray(jax.device_get(sim.state.overflow_total)).max())
    pos, vel = sim.particles()
    assert np.isfinite(pos).all() and np.isfinite(vel).all()

    out = {
        "scene": "sharded-1m",
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "devices": args.devices,
        "n": sim.cfg.n,
        "grid_dims": list(sim.cfg.grid_dims),
        "steps": args.steps,
        "active_after": st["active_particles"],
        "lost": st["lost_particles"],
        "overflow_total": ovf,
        "kinetic_energy": st["kinetic_energy"],
        "per_device_counts_initial": counts0,
        "per_device_counts_final": st["per_device_counts"],
        "build_s": round(build_s, 1),
        "compile_plus_first_step_s": round(compile_s, 1),
        "wall_s_steady": round(wall, 1),
        "ms_per_step": round(1e3 * wall / max(args.steps - 1, 1), 1),
    }
    assert out["lost"] == 0.0, "migration lost particles"
    assert out["active_after"] == sim.cfg.n, "particle count not conserved"

    name = "sharded_1m_results.json"
    if args.bulk_velocity:
        out["bulk_velocity"] = args.bulk_velocity
        moved = sum(abs(a - b) for a, b in
                    zip(out["per_device_counts_final"],
                        out["per_device_counts_initial"])) // 2
        out["net_owner_changes_lower_bound"] = int(moved)
        assert (out["per_device_counts_final"]
                != out["per_device_counts_initial"]), \
            "bulk drift must change per-device counts"
        assert moved > 0
        name = "sharded_1m_migration_results.json"

    print(json.dumps(out, indent=1))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    main()

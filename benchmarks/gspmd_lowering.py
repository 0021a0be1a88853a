"""Verify + quantify the GSPMD sharded step's communication lowering.

Compiles one sharded bucket_grid step on the 8-virtual-device CPU mesh at a
realistically-proportioned grid and reports, per collective kind, the op
count and total bytes moved per step. The headline claim (see
parallel/gspmd.py and the matching test in tests/test_parallel.py): neighbor
rolls lower to one-slab collective-permutes, NOT whole-grid
all-gathers. The residual all-gathers are the per-particle gather-back
(plane-sharded results repartitioned to the particle axis).

    python benchmarks/gspmd_lowering.py
"""
from __future__ import annotations

import json
import os
import re

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    from water_sandbox.core.params import SimConfig, SimParams
    from water_sandbox.core.state import init_state
    from water_sandbox.models import scenes
    from water_sandbox.parallel import gspmd, mesh as mesh_mod

    grid_dims = (64, 16, 16)
    cap = 16
    pts = scenes.cube_fluid(16, 12, 12)
    cfg = SimConfig(n=pts.shape[0], dim=3, neighbor_mode="bucket_grid",
                    grid_dims=grid_dims, cell_capacity=cap)
    params = SimParams.create(dim=3)
    mesh = mesh_mod.make_mesh(8)
    state = gspmd.shard_state(init_state(pts), mesh)
    rollout = gspmd.make_sharded_rollout(mesh, cfg)
    hlo = jax.jit(lambda s, p: rollout(s, p, 1)).lower(
        state, params).compile().as_text()

    stats = {}
    op_re = re.compile(
        r"%((?:collective-permute|all-gather|all-to-all|all-reduce|"
        r"reduce-scatter)[\w.\-]*) = (\(?)([a-z]\d+)\[([\d,]*)\]")
    for m in op_re.finditer(hlo):
        kind = m.group(1).split(".")[0]
        elem_bytes = int(re.match(r"[a-z](\d+)", m.group(3)).group(1)) // 8
        size = elem_bytes
        if m.group(4):
            for d in m.group(4).split(","):
                size *= int(d)
        s = stats.setdefault(kind, {"count": 0, "bytes": 0, "max_op_bytes": 0})
        s["count"] += 1
        s["bytes"] += size
        s["max_op_bytes"] = max(s["max_op_bytes"], size)

    plane_bytes = cap * grid_dims[0] * grid_dims[1] * grid_dims[2] * 4
    out = {
        "grid_dims": list(grid_dims),
        "cell_capacity": cap,
        "n": int(cfg.n),
        "mesh": 8,
        "plane_bytes": plane_bytes,
        "per_step_collectives": stats,
        "note": ("collective-permute = one-slab halo exchanges (the rolls); "
                 "all-gather = per-particle gather-back repartitioning, "
                 "each bounded by one (cap, nc) plane"),
    }
    with open("benchmarks/gspmd_lowering_results.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

"""Generate golden-trajectory statistics for tests/test_golden.py.

    JAX_PLATFORMS=cpu python tools/gen_goldens.py dam-break-2d-4k bucket_grid 1000
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def stats(name, mode, steps, **kw):
    from water_sandbox.models import scenes
    from water_sandbox.ops.step import rollout

    cfg, params, state = scenes.build(name, neighbor_mode=mode, **kw)
    t0 = time.perf_counter()
    done = 0
    # 50-step chunks, the same composition the golden test runs
    while done < steps:
        chunk = min(50, steps - done)
        state = rollout(state, params, cfg, chunk)
        done += chunk
        np.asarray(state.pos)
        print(f"# {done}/{steps} ({time.perf_counter()-t0:.0f}s)",
              file=sys.stderr, flush=True)
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    speed = np.sqrt((vel ** 2).sum(axis=1))
    rho = np.asarray(state.density)
    return {
        "com": [round(float(x), 5) for x in pos.mean(0)],
        "ke": round(float(0.5 * (vel ** 2).sum()), 2),
        "bbox_lo": [round(float(x), 5) for x in pos.min(0)],
        "bbox_hi": [round(float(x), 5) for x in pos.max(0)],
        "mean_rho": round(float(rho.mean()), 4),
        # distributional pins: speed/density quantiles catch
        # re-equilibrated physics bugs that preserve the moments above
        "vq": [round(float(np.quantile(speed, q)), 5)
               for q in (0.1, 0.5, 0.9)],
        "rq": [round(float(np.quantile(rho, q)), 4)
               for q in (0.1, 0.5, 0.9)],
        "overflow": int(np.asarray(state.overflow)),
        "overflow_total": float(np.asarray(state.overflow_total)),
    }


if __name__ == "__main__":
    name, mode, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
    kw = json.loads(sys.argv[4]) if len(sys.argv) > 4 else {}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    out = stats(name, mode, steps, **kw)
    print(json.dumps({f"{name}|{mode}|{steps}": out}))

"""Golden-suite sensitivity check: demonstrate the
golden pins actually FAIL under an injected physics bug.

Mutation: flip the sign of the near-pressure kernel derivative
(KernelCoeffs.pow3_der — the `dw_near` channel, ops/kernels.py:42-47).
This turns the short-range anti-clustering repulsion into attraction, a
bug class that can re-equilibrate to similar *bulk* statistics; the
distributional quantile pins (vq/rq) exist precisely for this case.

For each fast golden entry the mutated trajectory is evaluated against the
pinned values with the test's own tolerances, and the set of tripped pins
is recorded. The run FAILS (exit 1) if any scene/mode survives the
mutation with every pin green.

    python benchmarks/golden_sensitivity.py      # runs on the CPU
"""
from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # the goldens are CPU pins
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np  # noqa: E402

# the fast (default-suite) goldens — the regression net every CI run casts
CASES = [
    ("dam-break-2d-4k", "bucket_grid", 40),
    ("mini-3d", "dense", 60),
    ("mini-3d", "bucket_grid", 60),
]


def _golden_table():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), os.pardir, "tests"))
    import test_golden
    return test_golden.GOLDEN


def _flip_dw_near():
    """Negate pow3_der inside the traced step — every pipeline (dense,
    bucket_grid, hash_grid) derives its coefficients from this one factory."""
    from water_sandbox.core.params import KernelCoeffs
    import dataclasses

    orig = KernelCoeffs.from_radius

    def mutated(h, dim):
        k = orig(h, dim)
        return dataclasses.replace(k, pow3_der=-k.pow3_der)

    KernelCoeffs.from_radius = staticmethod(mutated)


def _tripped_pins(key, g):
    """Run the MUTATED trajectory and evaluate each golden pin with the
    same tolerances as tests/test_golden.py; returns the tripped set."""
    from water_sandbox.models import scenes
    from water_sandbox.ops.step import rollout

    name, mode, steps = key
    cfg, params, state = scenes.build(name, neighbor_mode=mode,
                                      **g.get("kw", {}))
    done = 0
    while done < steps:
        chunk = min(50, steps - done)
        state = rollout(state, params, cfg, chunk)
        done += chunk
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    rho = np.asarray(state.density)
    speed = np.sqrt((vel**2).sum(axis=1))

    def close(a, b, rtol=0.0, atol=0.0):
        return bool(np.allclose(a, b, rtol=rtol, atol=atol))

    tripped = []
    if not close(pos.mean(0), g["com"], atol=2e-3):
        tripped.append("com")
    if not close(0.5 * (vel**2).sum(), g["ke"], rtol=2e-3):
        tripped.append("ke")
    if "bbox_lo" in g:
        if not (close(pos.min(0), g["bbox_lo"], atol=5e-3)
                and close(pos.max(0), g["bbox_hi"], atol=5e-3)):
            tripped.append("bbox")
    if not close(rho.mean(), g["mean_rho"], rtol=2e-3):
        tripped.append("mean_rho")
    if "vq" in g and not close(np.quantile(speed, (0.1, 0.5, 0.9)),
                               g["vq"], rtol=2e-3, atol=1e-3):
        tripped.append("vq")
    if "rq" in g and not close(np.quantile(rho, (0.1, 0.5, 0.9)),
                               g["rq"], rtol=2e-3):
        tripped.append("rq")
    return tripped


def main():
    golden = _golden_table()
    _flip_dw_near()

    results, ok = {}, True
    for key in CASES:
        g = golden[key]
        tripped = _tripped_pins(key, g)
        label = "|".join(map(str, key))
        results[label] = tripped
        print(f"{label}: tripped {tripped or 'NOTHING'}", file=sys.stderr)
        if not tripped:
            ok = False

    out = {
        "mutation": "KernelCoeffs.pow3_der sign flip (dw_near channel)",
        "tripped_pins": results,
        "all_cases_caught": ok,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden_sensitivity.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()

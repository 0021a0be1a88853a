"""Step-throughput benchmark: ONE JSON line, measured on a GPU.

Measures settled ms/step and particle-steps/s of the normal
``Simulation``/``rollout`` path on the flagship scene
(``moving-container-256k``) and, as a head-to-head, on the reference's own
scene (``reference-cube``). The line names the device it ran on; with no GPU
the script exits non-zero before measuring anything.

Protocol: timed windows run from a SETTLED state, settled with the same
compiled rollout program that is then timed (the warm-up compiles exactly
the measured program); best of 3 windows; the transient (fresh lattice)
rate is reported alongside. settle = 600 steps, window = 50 steps. The JSON
carries a config fingerprint so any scene retune is visible in the artifact
itself. Env overrides (WST_BENCH_*) exist for experiments only.

    python bench.py
"""

import json
import os
import sys
import time

PROTOCOL = "settle600+best3x50+block_until_ready"


def measure(scene, chunk, settle):
    import jax
    from water_sandbox.ops.step import rollout
    from water_sandbox.runtime.runner import Simulation

    sim = Simulation.from_scene(scene)

    def sync():
        jax.block_until_ready(sim.state)

    # first chunk: compile + transient window
    sim.state = rollout(sim.state, sim.params, sim.cfg, chunk)
    sync()
    t0 = time.perf_counter()
    sim.state = rollout(sim.state, sim.params, sim.cfg, chunk)
    sync()
    transient = chunk * sim.cfg.n / (time.perf_counter() - t0)

    # settle with the same program
    done = 2 * chunk
    while done < settle:
        sim.state = rollout(sim.state, sim.params, sim.cfg, chunk)
        done += chunk
    sync()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sim.state = rollout(sim.state, sim.params, sim.cfg, chunk)
        sync()
        walls.append(time.perf_counter() - t0)
    rate = chunk * sim.cfg.n / min(walls)
    return sim, rate, transient, done


def true_pairs(pos, h, chunk=1024):
    """Interacting (d <= h) ordered pairs, self included: a chunked O(n²)
    sweep whose (chunk, n, dim) block stays a few GB at 266k particles."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def count(pos, h):
        n = pos.shape[0]
        n_pad = -(-n // chunk) * chunk
        padded = jnp.pad(pos, ((0, n_pad - n), (0, 0)),
                         constant_values=1e15)
        chunks = padded.reshape(n_pad // chunk, chunk, -1)

        def body(tot, cpos):
            d2 = jnp.sum((cpos[:, None, :] - pos[None, :, :]) ** 2, -1)
            return tot + jnp.sum(d2 <= h * h), None

        tot, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32), chunks)
        return tot

    return float(count(pos, h))


def fingerprint(sim):
    return {
        "scene": sim.name, "n": sim.cfg.n,
        "neighbor_mode": sim.cfg.neighbor_mode,
        "grid_dims": list(sim.cfg.grid_dims),
        "grid_frame": sim.cfg.grid_frame,
        "cell_capacity": sim.cfg.cell_capacity,
        "dt": float(sim.params.dt),
        "pressure_scalar": float(sim.params.pressure_scalar),
    }


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from water_sandbox.runtime import compile_cache

    compile_cache.configure()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench.py measures a GPU; JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        sys.exit(1)

    scene = os.environ.get("WST_BENCH_SCENE", "moving-container-256k")
    chunk = int(os.environ.get("WST_BENCH_STEPS", "50"))
    settle = int(os.environ.get("WST_BENCH_SETTLE", "600"))

    sim, rate, transient, done = measure(scene, chunk, settle)
    pairs = true_pairs(sim.state.predicted, sim.params.smoothing_radius)

    out = {
        "metric": (f"particle-steps/s ({scene}, n={sim.cfg.n}, "
                   f"settled@{done}; transient={transient:.3g})"),
        "value": round(rate, 1),
        "unit": "particle-steps/s",
        "ms_per_step": round(1e3 * sim.cfg.n / rate, 2),
        "protocol": PROTOCOL,
        "true_pairs_per_particle": round(pairs / sim.cfg.n, 1),
        "config": fingerprint(sim),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
    }

    # head-to-head on the reference's OWN scene (skip if it was primary)
    if scene != "reference-cube" and not os.environ.get("WST_BENCH_NO_REF"):
        sim_r, rate_r, _, _ = measure("reference-cube", chunk, settle)
        out["reference_scene_ps_per_s"] = round(rate_r, 1)
        out["reference_scene_ms_per_step"] = round(1e3 * 65536 / rate_r, 2)
        out["reference_scene_config"] = fingerprint(sim_r)

    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Run the simulator's main path once on a GPU and check what comes out.

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # four GPUs: the multi-device phase only

One process, the normal entry points, full scene widths. Phases:

1. device — JAX's first device must be a GPU (no CPU carry-on); the card's
   name and power limit come from ``nvidia-smi`` (a child that does not
   import JAX).
2. main path — ``interactive-2d-16k``, ``reference-cube`` and
   ``moving-container-256k`` step through ``Simulation.run``: positions
   finite and inside the (possibly moving) box, ``overflow_total == 0``,
   kinetic energy finite and bounded, mean density positive. Compile time,
   steady ms/step and peak device memory are printed beside the card. The
   CLI's ``run`` command then runs in this process.
3. parity — one ``bucket_grid`` evaluation against the row-blocked dense
   oracle at 65,536 and 266,112 particles, in float32 at the tolerances of
   tests/test_grid.py; and the mini-3d ``bucket_grid`` golden of
   tests/test_golden.py.

``--four-cards`` runs only the multi-device phase: ``DistributedSimulation``
and the GSPMD rollout on ``sharded-1m`` over a 4-device mesh, each compared
as a point set with the single-card ``bucket_grid`` trajectory on card 0.

Every failure raises, so the script exits non-zero and prints no result.
The last line of standard output is the result, one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# smallest first, so the process's peak memory after each scene is that
# scene's own peak
SCENES = ("interactive-2d-16k", "reference-cube", "moving-container-256k")
STEPS = 200
# warm-up before the timed window: compiles Simulation.run's 64- and 8-step
# rollout programs, the two a 200-step run uses (64·3 + 8)
WARM_STEPS = 72
# no scene moves faster than a few m/s (wall sweeps stay below the EOS
# sound speed, sqrt(100) = 10 m/s at most); a blow-up exceeds this at once
MAX_SPEED = 50.0
PARITY_SCENES = ("reference-cube", "moving-container-256k")
# (rtol, atol) per field: float32, as tests/test_grid.py holds bucket_grid
# to the dense oracle
TOLERANCES = {"den": (1e-5, 0.0), "nden": (1e-5, 0.0),
              "prs": (1e-4, 1e-4), "nprs": (1e-4, 1e-4),
              "acc": (2e-4, 2e-4)}
GOLDEN_KEY = ("mini-3d", "bucket_grid", 60)

FOUR_CARD_SCENE = "sharded-1m"
FOUR_CARD_STEPS = 8
# uniform +x drift for the four-card run: every lattice column crosses a
# device boundary's predicted-position test within a few steps, so the
# migration path really runs (a fluid at rest keeps its per-device counts)
DRIFT = 3.0
# one lattice column of sharded-1m (24 x 85 particles) crosses a slab
# boundary in a single step under the drift; the send buffers must hold it
MIG_CAP = 4096
POINT_TOL = 1e-3  # L1 distance to the nearest single-card particle


def check(ok, message) -> None:
    """Fail the run (an explicit raise: ``python -O`` strips asserts)."""
    if not ok:
        raise AssertionError(message)


def card_line() -> str:
    """The cards' names and power limits, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def require_gpu(devices, count: int = 1) -> None:
    """Refuse anything but GPUs (at least ``count`` of them)."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke.py needs {count} GPUs; JAX found "
                         f"{len(devices)}")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def check_parity(got: dict, want: dict) -> dict:
    """Worst error of each field, as (max |got - want|, worst ratio of the
    error to its tolerance atol + rtol·|want|). Raises if any ratio exceeds
    1 or any value is not finite."""
    worst = {}
    for name, (rtol, atol) in TOLERANCES.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(want[name], np.float64)
        check(g.shape == w.shape, (name, g.shape, w.shape))
        check(np.isfinite(g).all() and np.isfinite(w).all(), name)
        err = np.abs(g - w)
        worst[name] = (float(err.max()),
                       float((err / (atol + rtol * np.abs(w))).max()))
    bad = {k: v for k, v in worst.items() if not v[1] <= 1.0}
    check(not bad, f"fields outside tolerance: {bad}")
    return worst


def _check_state(sim) -> dict:
    """Sanity of a stepped Simulation; returns its stats."""
    import jax.numpy as jnp

    from water_sandbox.ops import integrate as integrate_mod

    s, params = sim.state, sim.params
    pos = np.asarray(s.pos)
    check(np.isfinite(pos).all(), "non-finite positions")
    center, angle = integrate_mod.container_at(params.container, s.time)
    local = np.asarray(integrate_mod._rotate_yaw(
        jnp.asarray(pos) - center, angle, inverse=True))
    half = np.asarray(params.container.half_size)
    check((np.abs(local) <= half + 1e-3).all(), "particle outside the box")
    check(float(s.overflow_total) == 0.0, "overflow beyond the rescue")
    st = sim.stats()
    check(np.isfinite(st["kinetic_energy"]), "non-finite kinetic energy")
    check(st["max_speed"] <= MAX_SPEED, f"max speed {st['max_speed']}")
    check(st["mean_density"] > 0.0, "mean density not positive")
    return st


def run_scene(name: str, card: str):
    import jax

    from water_sandbox import Simulation

    sim = Simulation.from_scene(name)
    t0 = time.perf_counter()
    sim.run(WARM_STEPS)
    jax.block_until_ready(sim.state)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.run(STEPS)
    jax.block_until_ready(sim.state)
    ms = 1e3 * (time.perf_counter() - t0) / STEPS
    st = _check_state(sim)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    compile_s = warm - WARM_STEPS * ms / 1e3
    print(f"[{card}] {name}: n={sim.cfg.n} compile {compile_s:.6g} s "
          f"(warm-up {warm:.6g} s incl. {WARM_STEPS} steps), "
          f"{ms:.6g} ms/step over {STEPS} steps, peak device memory "
          f"{peak / 2**30:.6g} GiB, overflow_total 0, "
          f"KE {st['kinetic_energy']:.6g}, max speed {st['max_speed']:.4g}"
          f" m/s, mean density {st['mean_density']:.6g}", flush=True)
    return sim


def run_cli(card: str) -> None:
    from water_sandbox import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["run", "--scene", "dam-break-2d-4k", "--steps", "100"])
    stats = json.loads([ln for ln in buf.getvalue().splitlines()
                        if ln.startswith("{")][-1])
    check(stats["step"] == 100, stats)
    check(np.isfinite(stats["kinetic_energy"]), stats)
    print(f"[{card}] cli run --scene dam-break-2d-4k --steps 100: "
          f"step {stats['step']}, KE {stats['kinetic_energy']:.6g}",
          flush=True)


def _bucket_fields(cfg, pred, vel, params, t):
    from water_sandbox.core.params import KernelCoeffs
    from water_sandbox.ops import grid

    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    den, nden, prs, nprs, acc, unrescued = grid.bucket_sph(
        pred, vel, params, coeffs, cfg, time=t)
    return dict(den=den, nden=nden, prs=prs, nprs=nprs, acc=acc), unrescued


def _oracle_fields(pred, vel, params):
    from water_sandbox.core.params import KernelCoeffs
    from water_sandbox.ops import dense

    coeffs = KernelCoeffs.from_radius(params.smoothing_radius,
                                      pred.shape[1])
    den, nden, prs, nprs = dense.density_pass_blocked(pred, params, coeffs)
    acc = dense.force_pass_blocked(pred, vel, den, nden, prs, nprs, params,
                                   coeffs)
    return dict(den=den, nden=nden, prs=prs, nprs=nprs, acc=acc)


def run_parity(sim, card: str) -> None:
    import jax

    s = sim.state
    got, unrescued = jax.jit(partial(_bucket_fields, sim.cfg))(
        s.predicted, s.vel, sim.params, s.time)
    check(int(unrescued) == 0, "parity state overflowed the rescue")
    t0 = time.perf_counter()
    want = jax.jit(_oracle_fields)(s.predicted, s.vel, sim.params)
    jax.block_until_ready(want)
    worst = check_parity(got, want)
    print(f"[{card}] parity {sim.name} (n={sim.cfg.n}, step "
          f"{int(s.step_count)}) bucket_grid vs row-blocked dense oracle "
          f"({time.perf_counter() - t0:.3g} s): " + ", ".join(
              f"{k} max|err| {e:.3g} ({r:.3g} of tol)"
              for k, (e, r) in worst.items()), flush=True)


def run_golden(card: str) -> None:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_golden

    test_golden.check_golden(GOLDEN_KEY, test_golden.run_golden(GOLDEN_KEY))
    print(f"[{card}] golden {GOLDEN_KEY} holds against its CPU pins",
          flush=True)


def point_set_distance(a, b) -> float:
    """Largest L1 distance from a row of ``a`` to its nearest row of ``b``
    (row order differs across devices)."""
    from scipy.spatial import cKDTree

    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape, (a.shape, b.shape))
    dist, _ = cKDTree(b).query(a, k=1, p=1)
    return float(dist.max())


def four_card_phase(cfg, params, state, steps: int, card: str,
                    ndev: int = 4) -> None:
    """DistributedSimulation and the GSPMD rollout over an ndev-device mesh,
    each against the single-device bucket_grid trajectory (device 0)."""
    import jax
    import jax.numpy as jnp

    from water_sandbox import DistributedSimulation, Simulation
    from water_sandbox.parallel import gspmd, mesh as mesh_mod

    fresh = lambda: jax.tree.map(jnp.copy, state)  # rollouts donate

    dist = DistributedSimulation(cfg, params, fresh(), n_devices=ndev,
                                 mig_cap=MIG_CAP, name=FOUR_CARD_SCENE)
    before = dist.stats()["per_device_counts"]
    t0 = time.perf_counter()
    dist.run(steps)
    st = dist.stats()
    wall = time.perf_counter() - t0
    check(st["lost_particles"] == 0.0,
          f"migration lost {st['lost_particles']} particles")
    check(float(dist.state.overflow_total) == 0.0, "domain overflow")
    check(st["active_particles"] == cfg.n,
          f"{st['active_particles']} of {cfg.n} particles active")
    check(st["per_device_counts"] != before, "no particle migrated")

    mesh = mesh_mod.make_mesh(ndev)
    t0 = time.perf_counter()
    sharded = gspmd.make_sharded_rollout(mesh, cfg)(
        gspmd.shard_state(fresh(), mesh), params, steps)
    jax.block_until_ready(sharded)
    wall_g = time.perf_counter() - t0
    check(float(sharded.overflow_total) == 0.0, "gspmd overflow")

    single = Simulation(cfg, params, fresh(), name=FOUR_CARD_SCENE)
    t0 = time.perf_counter()
    single.run(steps)
    jax.block_until_ready(single.state)
    wall_1 = time.perf_counter() - t0
    check(float(single.state.overflow_total) == 0.0, "single overflow")
    truth = single.positions()

    d_dom = point_set_distance(dist.particles()[0], truth)
    d_gspmd = point_set_distance(np.asarray(sharded.pos), truth)
    print(f"[{card}] {FOUR_CARD_SCENE} n={cfg.n}, {steps} steps, drift "
          f"{DRIFT} m/s: domain lost 0, overflow_total 0, per-device "
          f"counts {before} -> {st['per_device_counts']}; worst L1 point "
          f"distance to single card: domain {d_dom:.3g}, gspmd "
          f"{d_gspmd:.3g} (tol {POINT_TOL}); first-call walls incl. "
          f"compile: domain {wall:.4g} s, gspmd {wall_g:.4g} s, single "
          f"{wall_1:.4g} s", flush=True)
    check(d_dom < POINT_TOL, f"domain point distance {d_dom}")
    check(d_gspmd < POINT_TOL, f"gspmd point distance {d_gspmd}")


def _drifting(name: str):
    from water_sandbox.models import scenes

    cfg, params, state = scenes.build(name)
    vel = state.vel.at[:, 0].set(DRIFT)
    return cfg, params, dataclasses.replace(state, vel=vel,
                                            predicted=state.pos + vel
                                            * params.lookahead)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device phase, on 4 GPUs")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    from water_sandbox.runtime import compile_cache

    compile_cache.configure()
    devices = jax.devices()
    require_gpu(devices, 4 if args.four_cards else 1)
    card = card_line()
    print(f"card: {card}", flush=True)

    if args.four_cards:
        four_card_phase(*_drifting(FOUR_CARD_SCENE), FOUR_CARD_STEPS, card)
    else:
        sims = {name: run_scene(name, card) for name in SCENES}
        run_cli(card)
        for name in PARITY_SCENES:
            run_parity(sims[name], card)
        run_golden(card)
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()

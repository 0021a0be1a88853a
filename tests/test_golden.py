"""Golden-trajectory regression tests (SURVEY.md §4): summary statistics of
fixed scenes after a fixed number of steps, generated on CPU float32 with
tools/gen_goldens.py.

Statistics (center of mass, kinetic energy, bounding box, mean density) are
robust to benign float reassociation across XLA versions but catch any
physics regression. Dense / bucket_grid pipelines have separate entries:
they compute identical pair sets, but summation-order differences grow
chaotically, so each pins its own trajectory. Every golden run must end
with overflow == 0 (exact physics for every particle).

The long entries run only when WST_SLOW=1 (the default suite stays fast).
Regenerate after any intentional physics change:

    JAX_PLATFORMS=cpu python tools/gen_goldens.py <scene> <mode> <steps> [kw]

``check_golden`` is shared with chip_smoke.py, which holds the mini-3d
bucket_grid pin on the GPU.
"""

import os

import numpy as np
import pytest

from water_sandbox.models import scenes
from water_sandbox.ops.step import rollout

slow = pytest.mark.skipif(not os.environ.get("WST_SLOW"),
                          reason="1k-step golden; set WST_SLOW=1")

GOLDEN = {
    # -- fast pins (default suite) ------------------------------------------
    ("dam-break-2d-4k", "bucket_grid", 40): dict(
        com=[-5.38959, -2.26117], ke=67018.78, mean_rho=200.864,
        bbox_lo=[-7.95, -4.45], bbox_hi=[-1.99916, 1.46529],
        vq=[3.29699, 6.45457, 6.73436], rq=[114.2681, 131.9989, 428.8856]),
    ("mini-3d", "dense", 60): dict(
        com=[0.0, -3.79511, 0.0], ke=10585.86,
        bbox_lo=[-2.28083, -4.4, -2.28083],
        bbox_hi=[2.28083, -3.10759, 2.28083], mean_rho=156.2288,
        vq=[1.7921, 5.23485, 8.81628], rq=[152.7888, 152.7888, 168.9122]),
    ("mini-3d", "bucket_grid", 60): dict(
        com=[0.0, -3.79511, 0.0], ke=10585.88,
        bbox_lo=[-2.28083, -4.4, -2.28083],
        bbox_hi=[2.28083, -3.10759, 2.28083], mean_rho=156.2288,
        vq=[1.79191, 5.23489, 8.81626], rq=[152.7888, 152.7888, 168.9144],
        kw=dict(grid_dims=(20, 16, 16), chunk=256)),
    # -- long pins (WST_SLOW=1) ---------------------------------------------
    # interactive-2d-16k with its interaction field ACTIVE: 16k 2-D,
    # viscosity on, static repulsive field at the origin
    ("interactive-2d-16k", "bucket_grid", 200): dict(
        com=[2e-05, -3.92324], ke=108318.05,
        bbox_lo=[-11.95, -5.95], bbox_hi=[11.95, -0.28695],
        mean_rho=157.3969,
        vq=[0.81671, 3.36906, 5.15743], rq=[111.945, 145.5129, 224.0327],
        marks=slow),
    ("mini-3d", "dense", 1000): dict(
        com=[0.04154, -4.39612, -0.03965], ke=45.85,
        bbox_lo=[-7.89691, -4.4, -4.39954],
        bbox_hi=[7.89818, -3.87854, 4.39991], mean_rho=152.8026,
        vq=[0.10718, 0.23346, 0.56609], rq=[152.7888, 152.7888, 152.7888],
        marks=slow),
    ("dam-break-2d-4k", "dense", 1000): dict(
        com=[-0.14036, -3.93962], ke=9659.11,
        bbox_lo=[-7.95, -4.45], bbox_hi=[7.95, -2.85276],
        mean_rho=214.1837,
        vq=[0.70559, 1.81522, 3.3783], rq=[140.9755, 212.3918, 285.7992],
        marks=slow),
    ("dam-break-2d-4k", "bucket_grid", 1000): dict(
        com=[-0.07213, -3.8838], ke=8483.95,
        bbox_lo=[-7.95, -4.45], bbox_hi=[7.95, -2.74188],
        mean_rho=195.7284,
        vq=[0.6484, 1.69228, 3.17495], rq=[133.4146, 192.937, 261.242],
        marks=slow),
}


def _params():
    out = []
    for key, g in GOLDEN.items():
        marks = g.get("marks")
        out.append(pytest.param(key, marks=marks) if marks is not None
                   else key)
    return out


def run_golden(key):
    """The golden scene's final state: its registry config under the
    golden's neighbor mode, stepped in 50-step rollouts."""
    name, mode, steps = key
    cfg, params, state = scenes.build(name, neighbor_mode=mode,
                                      **GOLDEN[key].get("kw", {}))
    s = state
    done = 0
    while done < steps:
        chunk = min(50, steps - done)
        s = rollout(s, params, cfg, chunk)
        done += chunk
    return s


def check_golden(key, s):
    """Assert the final state ``s`` matches the pinned statistics."""
    g = GOLDEN[key]
    pos = np.asarray(s.pos)
    vel = np.asarray(s.vel)

    assert float(np.asarray(s.overflow_total)) == 0.0, (
        "golden runs drop no particles on ANY step (overflow beyond the "
        "rescue budget)")
    np.testing.assert_allclose(pos.mean(0), g["com"], atol=2e-3)
    np.testing.assert_allclose(0.5 * (vel**2).sum(), g["ke"], rtol=2e-3)
    if "bbox_lo" in g:
        np.testing.assert_allclose(pos.min(0), g["bbox_lo"], atol=5e-3)
        np.testing.assert_allclose(pos.max(0), g["bbox_hi"], atol=5e-3)
    np.testing.assert_allclose(np.asarray(s.density).mean(), g["mean_rho"],
                               rtol=2e-3)
    # distributional pins: speed/density quantiles catch re-equilibrated
    # physics bugs that preserve the bulk moments above — demonstrated by
    # benchmarks/golden_sensitivity.py (a dw_near sign flip trips these).
    if "vq" in g:
        speed = np.sqrt((vel**2).sum(axis=1))
        np.testing.assert_allclose(
            np.quantile(speed, (0.1, 0.5, 0.9)), g["vq"],
            rtol=2e-3, atol=1e-3)
    if "rq" in g:
        np.testing.assert_allclose(
            np.quantile(np.asarray(s.density), (0.1, 0.5, 0.9)), g["rq"],
            rtol=2e-3)


@pytest.mark.parametrize("key", _params())
def test_golden_trajectory(key):
    check_golden(key, run_golden(key))

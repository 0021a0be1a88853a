"""The parts of chip_smoke.py (and bench.py) that need no GPU: the device
check, the result line, the parity check, the compile-cache placement, and
the four-card phase on a small scene over 4 virtual CPU devices."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from water_sandbox.runtime import compile_cache  # noqa: E402


def _fake_devices(platform, kind, count):
    return [types.SimpleNamespace(platform=platform, device_kind=kind)
            ] * count


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu(_fake_devices("gpu", "H100", 1), 4)
    chip_smoke.require_gpu(_fake_devices("gpu", "H100", 4), 4)


def test_result_line_shape():
    line = chip_smoke.result_line(
        _fake_devices("gpu", "NVIDIA H100 80GB HBM3", 1))
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def _fields(seed=0, n=50):
    rng = np.random.RandomState(seed)
    f = {k: rng.rand(n) * 100 + 150 for k in ("den", "nden", "prs", "nprs")}
    f["acc"] = rng.randn(n, 3) * 10
    return f


def test_parity_check_passes_within_tolerance():
    want = _fields()
    got = {k: v * (1 + 1e-7) for k, v in want.items()}
    worst = chip_smoke.check_parity(got, want)
    assert set(worst) == set(chip_smoke.TOLERANCES)
    assert all(r <= 1.0 for _, r in worst.values())


@pytest.mark.parametrize("field", ["den", "acc"])
def test_parity_check_fails_on_perturbed_field(field):
    want = _fields()
    got = dict(want)
    got[field] = want[field].copy()
    got[field].flat[7] *= 1.01
    with pytest.raises(AssertionError, match=field):
        chip_smoke.check_parity(got, want)


def test_compile_cache_follows_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    got = compile_cache.configure({"JAX_COMPILATION_CACHE_DIR": "/x/cache"})
    assert got == "/x/cache"
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    got = compile_cache.configure({})
    assert got == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", got)]


def _run_script(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """No GPU (and, alone, none of the program): non-zero exit and no
    result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = _run_script(["chip_smoke.py"], cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_fails_without_gpu():
    out = _run_script(["bench.py"], REPO)
    assert out.returncode != 0
    assert "measures a GPU" in out.stderr
    assert out.stdout == ""


def test_four_card_phase_on_virtual_devices():
    """The --four-cards phase end to end at a small size on 4 of the 8
    virtual CPU devices: migration under the drift, parity of the domain
    and GSPMD paths with the single-device trajectory."""
    from water_sandbox.core.params import Container, SimConfig, SimParams
    from water_sandbox.core.state import init_state
    from water_sandbox.models import scenes

    pts = scenes.cube_fluid(18, 4, 4)  # spans the box: even device loads
    params = SimParams.create(
        dim=3, container=Container.create((0.0, 0.0, 0.0), (4.0, 3.0, 3.0)))
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(24, 16, 16),
                    cell_capacity=16, rescue_capacity=256)
    state = init_state(pts)
    vel = jnp.zeros_like(state.vel).at[:, 0].set(chip_smoke.DRIFT)
    state = dataclasses.replace(state, vel=vel)
    chip_smoke.four_card_phase(cfg, params, state, 6, "cpu")

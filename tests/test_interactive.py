"""Tests for the interactive layer: HUD keymap (hud.rs:130-165 semantics),
TUI frame rendering, and the browser viewer server."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest

from water_sandbox.runtime import keymap
from water_sandbox.runtime.runner import Simulation, SimPhase


@pytest.fixture()
def sim():
    # dense mode: 512 particles all-pairs is trivial on CPU, while the
    # scene's default bucket grid (sized for the full container) is not
    return Simulation.from_scene("mini-3d", neighbor_mode="dense")


def test_keymap_mirrors_reference(sim):
    h0 = float(sim.params.smoothing_radius)
    keymap.apply_key(sim, "2")
    assert float(sim.params.smoothing_radius) == pytest.approx(h0 + 0.1)
    keymap.apply_key(sim, "1")
    assert float(sim.params.smoothing_radius) == pytest.approx(h0)

    k0 = float(sim.params.pressure_scalar)
    keymap.apply_key(sim, "q")
    assert float(sim.params.pressure_scalar) == pytest.approx(k0 - 0.1)
    keymap.apply_key(sim, "w")
    keymap.apply_key(sim, "w")
    assert float(sim.params.pressure_scalar) == pytest.approx(k0 + 0.1)

    for key, field, sign in (("a", "near_pressure_scalar", -1),
                             ("s", "near_pressure_scalar", +1),
                             ("z", "target_density", -1),
                             ("x", "target_density", +1),
                             ("e", "viscosity_strength", -1),
                             ("r", "viscosity_strength", +1)):
        v0 = float(getattr(sim.params, field))
        keymap.apply_key(sim, key)
        assert float(getattr(sim.params, field)) == pytest.approx(
            v0 + sign * 0.1), key

    # 3 raises gravity.y toward zero, 4 lowers (hud.rs:151-154)
    g0 = float(sim.params.gravity[1])
    keymap.apply_key(sim, "3")
    assert float(sim.params.gravity[1]) == pytest.approx(g0 + 0.1)
    keymap.apply_key(sim, "0")
    assert float(sim.params.gravity[1]) == 0.0
    keymap.apply_key(sim, "9")
    assert float(sim.params.gravity[1]) == pytest.approx(-9.8)


def test_keymap_radius_floor(sim):
    sim.tune(smoothing_radius=0.05)
    out = keymap.apply_key(sim, "1")
    assert "minimum" in out
    assert float(sim.params.smoothing_radius) == pytest.approx(0.05)


def test_keymap_pause_and_reset(sim):
    sim.run(2)
    keymap.apply_key(sim, "p")
    assert sim.phase is SimPhase.PAUSED
    keymap.apply_key(sim, " ")
    assert int(sim.state.step_count) == 0


def test_live_frame_rendering(sim):
    from water_sandbox.viz import live, raster
    sim.run(2)
    img = np.asarray(raster.density_image(sim.state, sim.params, 40, 12))
    txt = live.render_frame(img, color=False)
    assert len(txt.splitlines()) == 12
    ansi = live.render_frame(img, color=True)
    assert "\x1b[48;5;" in ansi


def test_live_loop_headless(sim, monkeypatch):
    """Drive run_live with a stubbed terminal feeding keys."""
    from water_sandbox.viz import live

    keys = iter([["w"], [" "], []])

    class FakeTerm:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read_keys(self):
            return next(keys, [])

    monkeypatch.setattr(live, "_RawTerminal", FakeTerm)
    out = io.StringIO()
    k0 = float(sim.params.pressure_scalar)
    live.run_live(sim, width=32, height=8, steps_per_frame=1, max_frames=3,
                  color=False, out=out)
    assert float(sim.params.pressure_scalar) == pytest.approx(k0 + 0.1)
    assert int(sim.state.step_count) == 1  # reset at frame 2, 1 step after
    assert "step" in out.getvalue()


def test_viewer_server_roundtrip(sim):
    from water_sandbox.viz.server import ViewerServer

    sim.run(1)     # warm the 1-step program + stats reductions outside the
    sim.stats()    # server loop so polling below isn't racing the compiler
    server = ViewerServer(sim, port=0, steps_per_frame=1)  # ephemeral port
    t = threading.Thread(target=server.serve, kwargs={"max_seconds": 30.0})
    t.start()
    try:
        host, port = server.httpd.server_address[:2]
        base = f"http://{host}:{port}"
        # wait for the first frame (first step compiles for a few seconds)
        import time
        for _ in range(300):
            body = urllib.request.urlopen(f"{base}/state.json",
                                          timeout=5).read()
            if body != b"{}":
                break
            time.sleep(0.1)
        frame = json.loads(body)
        assert frame["dim"] == 3
        import base64
        pos = np.frombuffer(base64.b64decode(frame["pos"]), np.float32)
        assert pos.size % 3 == 0 and np.isfinite(pos).all()
        assert "hud" in frame and "h=" in frame["hud"]

        page = urllib.request.urlopen(base, timeout=5).read().decode()
        assert "canvas" in page

        k0 = float(sim.params.pressure_scalar)
        desc = urllib.request.urlopen(f"{base}/key?k=w",
                                      timeout=5).read().decode()
        assert "pressure_scalar" in desc
        assert float(sim.params.pressure_scalar) == pytest.approx(k0 + 0.1)

        # mouse-driven interaction field (BASELINE config 2): /field aims
        # the InteractionField, the next frame advertises it, /field?off=1
        # disables it
        desc = urllib.request.urlopen(
            f"{base}/field?x=0.5&y=-0.25&z=0.1&s=-20", timeout=5
        ).read().decode()
        assert "field" in desc
        assert float(sim.params.field.strength) == pytest.approx(-20.0)
        np.testing.assert_allclose(np.asarray(sim.params.field.position),
                                   [0.5, -0.25, 0.1], atol=1e-6)
        assert float(sim.params.field.radius) > 0
        for _ in range(300):
            frame = json.loads(urllib.request.urlopen(
                f"{base}/state.json", timeout=5).read())
            if "field" in frame:
                break
            time.sleep(0.05)
        assert frame["field"]["s"] == pytest.approx(-20.0)
        assert frame["field"]["p"] == pytest.approx([0.5, -0.25, 0.1])
        desc = urllib.request.urlopen(f"{base}/field?off=1",
                                      timeout=5).read().decode()
        assert "off" in desc
        assert float(sim.params.field.strength) == 0.0
    finally:
        server.stop()
        t.join(timeout=30)
    assert not t.is_alive()


def test_viewer_server_raster_mode(sim):
    """Raster streaming: the 100k+ path ships an
    on-device density/speed raster instead of a point cloud."""
    from water_sandbox.viz.server import ViewerServer

    sim.run(1)
    sim.stats()
    server = ViewerServer(sim, port=0, steps_per_frame=1, render="raster",
                          raster_size=(96, 54))
    t = threading.Thread(target=server.serve, kwargs={"max_seconds": 30.0})
    t.start()
    try:
        host, port = server.httpd.server_address[:2]
        import time
        for _ in range(300):
            body = urllib.request.urlopen(
                f"http://{host}:{port}/state.json", timeout=5).read()
            if body != b"{}":
                break
            time.sleep(0.1)
        frame = json.loads(body)
        assert frame["mode"] == "raster"
        import base64
        den = np.frombuffer(base64.b64decode(frame["den"]), np.uint8)
        assert den.size == frame["rw"] * frame["rh"]
        assert den.max() > 0  # the fluid actually shows up
        spd = np.frombuffer(base64.b64decode(frame["spd"]), np.uint8)
        assert spd.size == den.size
    finally:
        server.stop()
        t.join(timeout=30)
    assert not t.is_alive()

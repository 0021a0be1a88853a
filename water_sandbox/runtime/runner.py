"""The interactive runtime — app-shell analogue of the reference's Bevy layer.

Maps the reference's host-side machinery onto a functional runtime:

* ``GameState`` FSM Menu/InGame/Paused/GameOver
  (/root/reference/src/state.rs:4-46) → :class:`SimPhase` on
  :class:`Simulation` — ``run``/``pause`` gate stepping, ``reset`` replays
  the GameOver→InGame bounce (restore initial state, keep tuned params,
  src/fluid_compute.rs:505-525).
* HUD live tuning (src/hud.rs:130-165) → :meth:`Simulation.tune`: params are
  a jit *argument*, so any scalar (pressure, viscosity, gravity, smoothing
  radius…) changes take effect next step with **no recompilation** — the
  reference re-uploads uniforms each frame (src/fluid_compute.rs:479-481) to
  get the same effect.
* per-frame readback (src/fluid_compute.rs:478) → :meth:`positions` /
  :meth:`snapshot` fetch on demand; stepping itself never leaves the device.
"""

from __future__ import annotations

import dataclasses
import enum
import time as _time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.params import Container, SimConfig, SimParams
from ..core.state import FluidState
from ..models import scenes as scene_registry
from ..ops import step as step_mod
from . import metrics as metrics_mod


class SimPhase(enum.Enum):
    """The reference's GameState FSM (src/state.rs:4-11), minus the window
    menu: READY ≙ Menu (built, not yet stepped), RUNNING ≙ InGame,
    PAUSED ≙ Paused. GameOver is instantaneous in the reference (bounces back
    to InGame next frame, src/state.rs:44-46) — here it's the reset() call."""

    READY = "ready"
    RUNNING = "running"
    PAUSED = "paused"


class Simulation:
    """Stateful convenience wrapper around the pure step/rollout functions.

    The heavy lifting is always the jitted ``rollout``; this class only holds
    the current state pytree, the current params, and bookkeeping.
    """

    def __init__(self, cfg: SimConfig, params: SimParams, state: FluidState,
                 name: str = "custom"):
        self.cfg = cfg
        self.params = params
        self.state = state
        self.name = name
        self.phase = SimPhase.READY
        # rollout() donates state buffers; keep an unaliased copy for reset()
        self._initial_state = jax.tree.map(jnp.copy, state)
        self.metrics = metrics_mod.MetricsRecorder()
        self._sizes_seen: set[int] = set()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_scene(cls, name: str, **cfg_overrides) -> "Simulation":
        cfg, params, state = scene_registry.build(name, **cfg_overrides)
        return cls(cfg, params, state, name=name)

    # -- stepping ----------------------------------------------------------

    # rollout scan lengths are static — decompose arbitrary step counts into
    # a few fixed sizes so at most len(_CHUNKS) programs ever compile
    _CHUNKS = (256, 64, 8, 1)

    def run(self, num_steps: int = 1, block: bool = True) -> "Simulation":
        """Advance num_steps (fused device rollouts). Respects PAUSED.

        Windows that trigger a rollout compile (first use of a chunk size)
        are recorded as warm-up, not throughput (see MetricsRecorder)."""
        if self.phase is SimPhase.PAUSED:
            return self
        self.phase = SimPhase.RUNNING
        cache_size = getattr(step_mod.rollout, "_cache_size", None)
        before = cache_size() if cache_size else None
        t0 = _time.perf_counter()
        remaining = num_steps
        sizes_used = set()
        for size in self._CHUNKS:
            while remaining >= size:
                sizes_used.add(size)
                self.state = step_mod.rollout(self.state, self.params,
                                              self.cfg, size)
                remaining -= size
        if block:
            jax.block_until_ready(self.state)
            dt_wall = _time.perf_counter() - t0
            if cache_size:
                compiled = cache_size() > before
            else:  # fallback: first use of a chunk size by this Simulation
                compiled = not sizes_used <= self._sizes_seen
            self._sizes_seen |= sizes_used
            self.metrics.record_steps(num_steps, self.cfg.n, dt_wall,
                                      compiled=compiled)
        return self

    def step(self) -> "Simulation":
        return self.run(1)

    # -- FSM ---------------------------------------------------------------

    def pause(self) -> "Simulation":
        """Esc-toggle analogue (src/state.rs:34-40)."""
        if self.phase is SimPhase.RUNNING:
            self.phase = SimPhase.PAUSED
        elif self.phase is SimPhase.PAUSED:
            self.phase = SimPhase.RUNNING
        return self

    def reset(self) -> "Simulation":
        """Space-key scene reset (src/fluid_compute.rs:505-525): restore the
        initial particle state, keep the live-tuned params."""
        self.state = jax.tree.map(jnp.copy, self._initial_state)
        self.phase = SimPhase.READY
        return self

    # -- live tuning (HUD keymap analogue, src/hud.rs:130-165) -------------

    def tune(self, **kw) -> "Simulation":
        """Set any SimParams field by name; container/field accept dicts.

        e.g. ``sim.tune(viscosity_strength=0.2, gravity=(0,-4.9,0))`` or
        ``sim.tune(field={'position': (0,0), 'strength': -20, 'radius': 3})``.
        No recompile — params are traced jit arguments."""
        p = self.params
        updates: dict[str, Any] = {}
        for k, v in kw.items():
            if k == "container" and isinstance(v, dict):
                updates[k] = dataclasses.replace(
                    p.container, **{kk: jnp.asarray(vv, jnp.float32)
                                    for kk, vv in v.items()})
            elif k == "field" and isinstance(v, dict):
                updates[k] = dataclasses.replace(
                    p.field, **{kk: jnp.asarray(vv, jnp.float32)
                                for kk, vv in v.items()})
            elif k == "gravity":
                updates[k] = jnp.asarray(v, jnp.float32)
            else:
                updates[k] = jnp.asarray(v, jnp.float32)
        self.params = dataclasses.replace(p, **updates)
        return self

    def gravity_off(self):
        """HUD key 0 (src/hud.rs:158-159)."""
        return self.tune(gravity=[0.0] * self.cfg.dim)

    def gravity_on(self):
        """HUD key 9 (src/hud.rs:160-161)."""
        g = [0.0] * self.cfg.dim
        g[1] = -9.8
        return self.tune(gravity=g)

    # -- observation -------------------------------------------------------

    def _by_id(self, arr: np.ndarray) -> np.ndarray:
        """Rows in particle-id order: the identity for a state built here,
        a reorder for one restored from a distributed run's dense state
        (DistributedSimulation.to_dense_state keeps device row order)."""
        ids = np.asarray(self.state.ids)
        out = np.empty_like(arr)
        out[ids] = arr
        return out

    def positions(self) -> np.ndarray:
        """Device→host positions fetch, in particle-id order — the analogue
        of the reference's 5.24 MB staging readback per frame
        (src/fluid_compute.rs:478), but on demand instead of every step."""
        return self._by_id(np.asarray(self.state.pos))

    def velocities(self) -> np.ndarray:
        return self._by_id(np.asarray(self.state.vel))

    def snapshot(self) -> dict:
        """Full host-side state dict (also the checkpoint payload)."""
        return {f.name: np.asarray(getattr(self.state, f.name))
                for f in dataclasses.fields(self.state)}

    def stats(self) -> dict:
        """Physics observability the reference lacks (SURVEY.md §5): energy,
        extremes, density distribution — one fused device reduction."""
        s = self.state
        speed2 = jnp.sum(s.vel**2, axis=1)
        out = {
            "step": int(s.step_count),
            "time": float(s.time),
            "kinetic_energy": float(0.5 * jnp.sum(speed2)),
            "max_speed": float(jnp.sqrt(jnp.max(speed2))),
            "mean_density": float(jnp.mean(s.density)),
            "max_density": float(jnp.max(s.density)),
            "mean_pressure": float(jnp.mean(s.pressure)),
        }
        out.update(self.metrics.summary())
        return out

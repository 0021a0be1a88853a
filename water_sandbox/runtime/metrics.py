"""Step-throughput metrics — observability the reference lacks entirely
(SURVEY.md §5: its only instrumentation is two startup println!s)."""

from __future__ import annotations


class MetricsRecorder:
    """Accumulates wall-clock stepping stats; cheap enough to always be on.

    Windows in which a new rollout program compiled (first use of a chunk
    size) are accumulated separately as warm-up: throughput rates are
    computed from WARM windows only, so a fresh session's first ``stats()``
    reports the real stepping rate, not the compile. ``compiles_seen`` and
    the warm-up wall time stay visible in the summary."""

    def __init__(self):
        self.total_steps = 0
        self.total_wall_s = 0.0
        self.warmup_steps = 0
        self.warmup_wall_s = 0.0
        self.compiles_seen = 0
        self.last_rate = 0.0
        self.n = 0

    def record_steps(self, num_steps: int, n_particles: int, wall_s: float,
                     compiled: bool = False):
        self.n = n_particles
        if compiled:
            self.compiles_seen += 1
            self.warmup_steps += num_steps
            self.warmup_wall_s += wall_s
            return
        self.total_steps += num_steps
        self.total_wall_s += wall_s
        if wall_s > 0:
            self.last_rate = num_steps * n_particles / wall_s

    def summary(self) -> dict:
        out = {
            "wall_time_s": round(self.total_wall_s + self.warmup_wall_s, 6),
            "steps_timed": self.total_steps,
        }
        if self.compiles_seen:
            out["compiles_seen"] = self.compiles_seen
            out["warmup_wall_s"] = round(self.warmup_wall_s, 6)
        if self.total_wall_s > 0 and self.total_steps:
            out["particle_steps_per_s"] = (
                self.total_steps * self.n / self.total_wall_s)
            out["ms_per_step"] = 1000.0 * self.total_wall_s / self.total_steps
        return out

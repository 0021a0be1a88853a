"""Profiling hooks (SURVEY.md §5 — the reference has none: two println!s).

Thin, dependency-free wrappers over jax.profiler so a user can capture a
device trace of any simulation span and inspect it in TensorBoard/Perfetto,
plus a host-side section timer for coarse breakdowns.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler device trace for the enclosed span:

        with profiling.device_trace("/tmp/trace"):
            sim.run(100)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class SectionTimer:
    """Host-side wall-clock sections with device syncs at boundaries:
    pass a `sync` callable that waits for the device, e.g.
    ``lambda: jax.block_until_ready(sim.state)``."""

    def __init__(self, sync=None):
        self.sections: dict[str, float] = {}
        self._sync = sync or (lambda: None)

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.sections[name] = (self.sections.get(name, 0.0)
                                   + time.perf_counter() - t0)

    def summary(self) -> dict:
        return dict(sorted(self.sections.items(), key=lambda kv: -kv[1]))

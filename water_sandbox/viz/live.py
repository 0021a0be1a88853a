"""Live terminal session: watch the fluid and tune parameters from the
keyboard while it runs — the TUI counterpart of the reference's interactive
loop (HUD keymap /root/reference/src/hud.rs:130-165, pause FSM
src/state.rs:34-40, Space reset src/fluid_compute.rs:505-525).

    python -m water_sandbox.cli live --scene dam-break-2d-4k

The sim steps in device-fused chunks between frames; keys are read raw
(termios, no deps) and applied through runtime.keymap — params are jit
arguments, so tuning never recompiles.
"""

from __future__ import annotations

import select
import sys
import time

import numpy as np

from ..runtime import keymap

# 2-row-per-character block rendering: braille-free, works everywhere
_RAMP = " .:-=+*#%@"

_ANSI_COLORS = (232, 17, 18, 19, 20, 26, 32, 38, 44, 50, 49, 85, 121, 157,
                193, 229)


def _color_block(v: float) -> str:
    """Map a 0..1 density value to a 256-color ANSI block."""
    idx = min(int(v * (len(_ANSI_COLORS) - 1)), len(_ANSI_COLORS) - 1)
    return f"\x1b[48;5;{_ANSI_COLORS[idx]}m \x1b[0m"


def render_frame(img: np.ndarray, color: bool) -> str:
    img = np.asarray(img)
    top = np.percentile(img, 99.5) or 1.0
    norm = np.clip(img / max(top, 1e-6), 0.0, 1.0)
    rows = []
    for row in norm[::-1]:  # y up
        if color:
            rows.append("".join(_color_block(v) for v in row))
        else:
            rows.append("".join(
                _RAMP[min(int(v * (len(_RAMP) - 1)), len(_RAMP) - 1)]
                for v in row))
    return "\n".join(rows)


class _RawTerminal:
    """Raw-mode stdin for single-key reads; restores settings on exit."""

    def __enter__(self):
        import termios
        import tty
        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def read_keys(self) -> list[str]:
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return keys


def run_live(sim, width: int = 96, height: int = 28,
             steps_per_frame: int = 4, max_frames: int | None = None,
             color: bool = True, out=sys.stdout):
    """Interactive loop. Ctrl-C (or 'c') quits; see keymap.HELP for keys."""
    from . import raster

    message = keymap.HELP
    frame = 0
    t_last = time.perf_counter()
    try:
        with _RawTerminal() as term:
            while max_frames is None or frame < max_frames:
                if sim.phase.value != "paused":
                    sim.run(steps_per_frame, block=True)
                for key in term.read_keys():
                    if key in ("c", "\x03"):
                        raise KeyboardInterrupt
                    desc = keymap.apply_key(sim, key)
                    if desc:
                        message = desc
                img = raster.density_image(sim.state, sim.params, width,
                                           height)
                img = np.asarray(img)
                st = sim.stats()
                hud = (f"step {st['step']:>7}  t={st['time']:7.2f}s  "
                       f"KE={st['kinetic_energy']:.3g}  "
                       f"{st.get('particle_steps_per_s', 0):,.0f} ps/s")
                dt_wall = time.perf_counter() - t_last
                t_last = time.perf_counter()
                fps = 1.0 / dt_wall if dt_wall > 0 else 0.0
                out.write("\x1b[2J\x1b[H")  # clear + home
                out.write(render_frame(img, color) + "\n")
                out.write(f"{hud}  {fps:4.1f} fps  [{sim.phase.value}]\n")
                out.write(keymap.params_line(sim) + "\n")
                out.write(f"> {message}\n")
                out.flush()
                frame += 1
    except KeyboardInterrupt:
        pass
    out.write("\n")
    return sim

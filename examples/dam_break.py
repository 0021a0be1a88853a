"""Dam break end-to-end: run, tune mid-flight, export, render.

    python examples/dam_break.py          # the default JAX device
    JAX_PLATFORMS=cpu python examples/dam_break.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import water_sandbox as wst
from water_sandbox.io.export import TrajectoryWriter
from water_sandbox.viz import raster, render


def main():
    sim = wst.Simulation.from_scene("dam-break-2d-4k")
    writer = TrajectoryWriter("dam_break_traj.npz", {"scene": sim.name})

    for frame in range(20):
        sim.run(16)
        writer.add_frame(sim.positions(), float(sim.state.time))
        if frame == 9:
            # mid-run tuning — the HUD keymap analogue, no recompile
            sim.tune(viscosity_strength=0.2)
            sim.tune(field={"position": (4.0, -3.0), "strength": 30.0,
                            "radius": 2.5})

    print(sim.stats())
    print(raster.ascii_preview(
        raster.density_image(sim.state, sim.params, 96, 28)))

    traj = writer.write()
    gif = render.render_trajectory_gif(traj, "dam_break.gif", sim.params)
    print(f"wrote {traj} and {gif}")


if __name__ == "__main__":
    main()

"""water_sandbox — an SPH fluid-simulation framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
qts8n/water-sandbox (a Rust/Bevy/WGSL GPU fluid sandbox): double-density SPH
with spatial-hash neighbor search, interactive parameter tuning, scene
management, and — beyond the reference — 2-D scenes, interaction force
fields, moving containers, checkpointing, metrics, and multi-chip domain
decomposition over a device mesh.

Quick start::

    import water_sandbox as wst
    sim = wst.Simulation.from_scene("dam-break-2d-4k")
    sim.run(1000)
    positions = sim.positions()
"""

from .core.params import (Container, InteractionField, KernelCoeffs,
                          SimConfig, SimParams)
from .core.state import FluidState, init_state
from .models import scenes
from .models.scenes import cube_fluid
from .ops.step import rollout, step, trajectory
from .runtime.distributed import DistributedSimulation
from .runtime.runner import Simulation

__version__ = "0.1.0"

__all__ = [
    "Container", "InteractionField", "KernelCoeffs", "SimConfig", "SimParams",
    "FluidState", "init_state", "scenes", "cube_fluid", "step", "rollout",
    "trajectory", "Simulation", "DistributedSimulation", "__version__",
]

"""Domain-decomposed run over a device mesh (works on a CPU mesh too):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/multichip.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import water_sandbox as wst
from water_sandbox.core.params import Container, SimConfig, SimParams
from water_sandbox.core.state import init_state
from water_sandbox.models import scenes


def main():
    ndev = len(jax.devices())
    pts = scenes.cube_fluid(12, 8, 8)
    params = SimParams.create(
        dim=3, container=Container.create((0, 0, 0), (6.0, 4.0, 4.0)))
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(8 * ndev, 20, 20),
                    cell_capacity=16)
    sim = wst.DistributedSimulation(cfg, params, init_state(pts),
                                    n_devices=ndev, slack=float(ndev))
    for _ in range(5):
        sim.run(4)
        st = sim.stats()
        print(f"step {st['step']:3d} per-device {st['per_device_counts']} "
              f"lost={st['lost_particles']}")


if __name__ == "__main__":
    main()

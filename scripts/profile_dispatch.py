#!/usr/bin/env python
"""Wall-clock per cycle vs steps-per-dispatch: quantify per-dispatch
host overhead."""
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lsc_planner_tpu.runtime import enable_compilation_cache
enable_compilation_cache()

import jax.numpy as jnp

from lsc_planner_tpu.config import Param, GoalMode
from lsc_planner_tpu.missions import make_circle_mission
from lsc_planner_tpu.sim.simulator import SyncSimulator


def main():
    qn = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    mission = make_circle_mission(qn, radius=radius,
                                  world=(-w, -w, 0, w, w, 2.5))
    param = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=14,
                  max_neighbors=32 if qn > 64 else -1)
    sim = SyncSimulator(mission, param, dtype=jnp.float32)
    for fuse in (1, 10, 40):
        state = sim.initial_state()
        multi = sim.make_scan_cycle(fuse) if fuse > 1 else sim._cycle_jit
        out = multi(state)
        state = out[0]
        state.traj.block_until_ready()
        reps = max(1, 40 // fuse)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = multi(state)
            state = out[0]
        state.traj.block_until_ready()
        dt = (time.perf_counter() - t0) / (reps * fuse)
        print(f"qn={qn} fuse={fuse:3d}: {dt*1e3:8.3f} ms/cycle "
              f"({qn/dt:9.0f} agent-cycles/s)", flush=True)


if __name__ == "__main__":
    main()

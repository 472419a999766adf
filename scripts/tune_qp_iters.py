#!/usr/bin/env python
"""Closed-loop quality vs IPM iteration count (CPU f32, warm-started).

Runs the two reference benchmark scenarios end-to-end at qp_iterations in
{6, 8, 10, 14} and reports success / min safety ratio / flight stats, to
pick the smallest safe production count for the bench.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# a CPU study: pin the platform before jax is imported
os.environ["JAX_PLATFORMS"] = "cpu"

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from lsc_planner_tpu.config import Param, GoalMode
from lsc_planner_tpu.missions import load_mission, make_circle_mission
from lsc_planner_tpu.sim.simulator import SyncSimulator
from lsc_planner_tpu.world.esdf import ESDF

MISSION = "/root/reference/missions/multi_square16.json"
WORLD = "/root/reference/world/simple_forest.bt"
CIRCLE20 = "/root/reference/missions/multi_circle20.json"


def run_circle20(iters, s_min=1.0):
    param = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=iters,
                  qp_s_min=s_min)
    mission = load_mission(CIRCLE20, param)
    sim = SyncSimulator(mission, param, dtype=jnp.float32)
    s = sim.run(max_iterations=300)
    return dict(iters=s["iterations"], collided=bool(s["is_collided"]),
                safety=round(float(s["safety_ratio_agent"]), 4),
                dist=round(float(s["total_flight_distance"]), 1))


def run_square16(iters, s_min=1.0):
    import numpy as np
    param = Param(goal_mode=GoalMode.PRIOR_BASED, world_use_octomap=True,
                  qp_iterations=iters, multisim_max_noise=0.02,
                  qp_s_min=s_min)
    mission = load_mission(MISSION, param, rng=np.random.default_rng(11))
    esdf = ESDF.from_bt(WORLD, mission.world_min, mission.world_max,
                        dtype=jnp.float32)
    sim = SyncSimulator(mission, param, esdf=esdf, dtype=jnp.float32)
    s = sim.run(max_iterations=400)
    return dict(iters=s["iterations"], collided=bool(s["is_collided"]),
                safety=round(float(s["safety_ratio_agent"]), 4),
                dist=round(float(s["total_flight_distance"]), 1))


def main():
    for k, s_min in ((14, 1.0), (10, 1.0), (8, 1.0), (6, 1.0),
                     (8, 0.1), (6, 0.1), (6, 0.01)):
        for name, fn in (("circle20", run_circle20),
                         ("square16_forest", run_square16)):
            r = fn(k, s_min)
            print(json.dumps({"qp_iterations": k, "s_min": s_min,
                              "scenario": name, **r}), flush=True)


if __name__ == "__main__":
    main()

"""One matmul-precision policy: every contraction of every jitted planning
cycle is full f32.

On the H100 an f32 matmul at default precision may run in TF32 (~11
bits, ~7 cm at 148 m coordinates).  The cycle entry points trace under
`runtime.exact_f32`; this test lowers each of them to StableHLO on the
CPU and checks that every dot_general carries HIGHEST precision.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsc_planner_tpu.config import Param, GoalMode
from lsc_planner_tpu.missions import (ObstacleSpec, make_circle_mission,
                                      make_square_mission)
from lsc_planner_tpu.sim.simulator import SyncSimulator


def _circle_sim():
    # K-NN pruning on: the one-hot neighbour-selection matmul is traced
    mission = make_circle_mission(8, radius=4.0,
                                  world=(-6, -6, 0, 6, 6, 2.5))
    p = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=4,
              max_neighbors=4)
    return SyncSimulator(mission, p, dtype=jnp.float32)


def _wall_sim():
    # a static box folded into the ESDF: grid planner, corridor, LOS
    m = make_square_mission(2, half=3.0, world=(-5, -5, 0, 5, 5, 2.5))
    wall = ObstacleSpec(kind="static", pose=np.array([0.0, 0.0, 1.25]),
                        dimensions=np.array([0.3, 2.0, 1.25]))
    m = dataclasses.replace(m, obstacles=[wall])
    p = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=4)
    return SyncSimulator(m, p, dtype=jnp.float32)


def _lower_cycle(make_sim):
    sim = make_sim()
    return sim._cycle_jit.lower(sim.initial_state())


def _lower_scan():
    sim = _circle_sim()
    return sim.make_scan_cycle(2).lower(sim.initial_state())


def _lower_sharded():
    from lsc_planner_tpu.parallel import shard as pshard
    sim = _circle_sim()
    mesh = pshard.make_mesh(2)
    cycle = pshard.make_sharded_cycle(sim, mesh)
    return cycle.lower(pshard.shard_state(sim.initial_state(), mesh))


@pytest.mark.parametrize("which", ["cycle", "cycle_obstacles", "scan",
                                   "sharded"])
def test_every_cycle_contraction_is_highest(which):
    lowered = {
        "cycle": lambda: _lower_cycle(_circle_sim),
        "cycle_obstacles": lambda: _lower_cycle(_wall_sim),
        "scan": _lower_scan,
        "sharded": _lower_sharded,
    }[which]()
    dots = [ln for ln in lowered.as_text().splitlines()
            if "dot_general" in ln]
    assert len(dots) > 10, "no contractions found: the check is vacuous"
    loose = [ln.strip() for ln in dots
             if "precision = [HIGHEST, HIGHEST]" not in ln]
    assert not loose, f"{len(loose)} contractions below HIGHEST: {loose[:3]}"


def test_policy_is_scoped_to_the_traced_function():
    """exact_f32 sets the precision only while its function traces: the
    process default stays untouched (no global switch)."""
    from lsc_planner_tpu.runtime import exact_f32

    def f(x):
        return x @ x

    x = jnp.ones((4, 4), jnp.float32)
    inside = jax.jit(exact_f32(f)).lower(x).as_text()
    outside = jax.jit(f).lower(x).as_text()
    assert "precision = [HIGHEST, HIGHEST]" in inside
    assert "HIGHEST" not in outside

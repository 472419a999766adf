#!/usr/bin/env python
"""Scan-fused microbenches of the non-IPM cycle components at 1024 agents:
safety audit, priority goal planning, K-NN pruning, LSC construction, and
QP assembly overhead.  Each piece runs 20x inside one lax.scan dispatch
with carried data dependencies, so dispatch latency amortizes away and
XLA cannot dead-code or CSE the work."""
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lsc_planner_tpu.runtime import enable_compilation_cache, exact_f32
enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

from lsc_planner_tpu.config import Param, GoalMode
from lsc_planner_tpu.missions import make_circle_mission
from lsc_planner_tpu.sim.simulator import SyncSimulator
from lsc_planner_tpu.sim import audit
from lsc_planner_tpu.planner import constraints as cons

QN = 1024
K = 32
REPS = 20


def scan_time(name, body, init):
    fn = jax.jit(exact_f32(lambda c: jax.lax.scan(
        lambda c, _: (body(c), None), c, None, length=REPS)[0]))
    out = fn(init)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(init)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / REPS
    print(f"{name:34s} {dt*1e3:8.3f} ms", flush=True)
    return dt


def main():
    radius = max(4.0, 0.45 * QN / math.pi)
    w = radius + 2.0
    mission = make_circle_mission(QN, radius=radius,
                                  world=(-w, -w, 0, w, w, 2.5))
    param = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=14,
                  max_neighbors=K)
    sim = SyncSimulator(mission, param, dtype=jnp.float32)
    p = sim.param
    state = sim.initial_state()
    state, _ = sim._cycle_jit(state)
    state, _ = sim._cycle_jit(state)
    traj0 = state.traj
    pos0 = state.pos

    # --- audit ---
    def audit_body(traj):
        s = audit.step_safety_ratio(traj, sim.radius, sim.downwash, p.dt,
                                    p.multisim_record_time_step,
                                    p.multisim_time_step)
        return traj + (s * 1e-12)

    scan_time("safety audit (pairwise)", audit_body, traj0)

    # --- knn ---
    def knn_body(pos):
        d2 = jnp.sum((pos[None] - pos[:, None]) ** 2, axis=-1)
        d2 = jnp.where(jnp.eye(QN, dtype=bool), jnp.inf, d2)
        _, nbr = jax.lax.top_k(-d2, K)
        return pos + 1e-12 * nbr[:, :1].astype(pos.dtype)

    scan_time("knn (d2 + top_k)", knn_body, pos0)

    # --- priority goal planning ---
    def goal_body(pos):
        g, _floor = sim.goal_planner.plan(
            pos=pos, vel=state.vel, init_traj=traj0,
            desired_goal=state.desired_goal, seq=state.seq,
            radius=sim.radius, downwash=sim.downwash, prev_traj=traj0)
        return pos + 1e-12 * g

    scan_time("priority goal planning", goal_body, pos0)

    # --- lsc construction (with knn gather) ---
    def lsc_body(pos):
        d2 = jnp.sum((pos[None] - pos[:, None]) ** 2, axis=-1)
        d2 = jnp.where(jnp.eye(QN, dtype=bool), jnp.inf, d2)
        _, nbr = jax.lax.top_k(-d2, K)
        planes = cons.lsc_planes(
            traj0, traj0[nbr], sim.radius, sim.downwash,
            sim.radius[nbr], sim.downwash[nbr],
            jnp.ones((QN, K), bool), jnp.ones((QN, K), bool))
        return pos + 1e-12 * planes.normal[:, 0, 0]

    scan_time("lsc construction (+knn)", lsc_body, pos0)

    # --- QP with 1 iteration (setup + recover + 1 IPM iter) ---
    param1 = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=1,
                   max_neighbors=K)
    sim1 = SyncSimulator(mission, param1, dtype=jnp.float32)

    def qp_body(pos):
        d2 = jnp.sum((pos[None] - pos[:, None]) ** 2, axis=-1)
        d2 = jnp.where(jnp.eye(QN, dtype=bool), jnp.inf, d2)
        _, nbr = jax.lax.top_k(-d2, K)
        planes = cons.lsc_planes(
            traj0, traj0[nbr], sim.radius, sim.downwash,
            sim.radius[nbr], sim.downwash[nbr],
            jnp.ones((QN, K), bool), jnp.ones((QN, K), bool))
        planes = cons.concat_planes(planes, n_ctrl=sim.n + 1)
        res = sim1.optimizer.solve(
            pos, state.vel, state.acc, state.desired_goal,
            nominal_velocity=sim.nominal_velocity,
            max_vel=sim.max_vel, max_acc=sim.max_acc, planes=planes,
            world_min=sim.world_min, world_max=sim.world_max,
            y_warm=sim.optimizer.extract_y(traj0).astype(jnp.float32),
            dtype=jnp.float32)
        return pos + 1e-12 * res.traj[:, 0, 0]

    scan_time("lsc + qp(1 iter) + recover", qp_body, pos0)


if __name__ == "__main__":
    main()

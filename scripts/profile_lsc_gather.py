#!/usr/bin/env python
"""Attribute LSC-construction time: KNN trajectory gather vs hull compute.

Variants at (1024 agents, K=32):
  a) production: obs_pred = pred[nbr] (data-dependent gather)
  b) static-slice obstacles (no gather) -- isolates hull+normal compute
  c) gather replaced by one-hot matmul at highest precision
"""
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
from lsc_planner_tpu.planner import constraints as cons

QN, K, REPS = 1024, 32, 20


def scan_time(name, body, init):
    fn = jax.jit(exact_f32(lambda c: jax.lax.scan(
        lambda c, _: (body(c), None), c, None, length=REPS)[0]))
    out = fn(init)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(init)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / REPS
    print(f"{name:40s} {dt*1e3:8.3f} ms", flush=True)


def main():
    radius = max(4.0, 0.45 * QN / math.pi)
    w = radius + 2.0
    mission = make_circle_mission(QN, radius=radius,
                                  world=(-w, -w, 0, w, w, 2.5))
    param = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=14,
                  max_neighbors=K)
    sim = SyncSimulator(mission, param, dtype=jnp.float32)
    state = sim.initial_state()
    state, _ = sim._cycle_jit(state)
    traj0, pos0 = state.traj, state.pos

    ones = jnp.ones((QN, K), bool)

    def knn(pos):
        d2 = jnp.sum((pos[None] - pos[:, None]) ** 2, axis=-1)
        d2 = jnp.where(jnp.eye(QN, dtype=bool), jnp.inf, d2)
        return jax.lax.top_k(-d2, K)[1]

    def lsc_from(obs_pred, pos, nbr):
        planes = cons.lsc_planes(
            traj0, obs_pred, sim.radius, sim.downwash,
            sim.radius[nbr], sim.downwash[nbr], ones, ones)
        return pos + 1e-12 * planes.normal[:, 0, 0]

    def body_gather(pos):
        nbr = knn(pos)
        return lsc_from(traj0[nbr], pos, nbr)

    def body_static(pos):
        nbr = knn(pos)
        obs = jnp.broadcast_to(traj0[None, :K], (QN, K) + traj0.shape[1:])
        return lsc_from(obs, pos, nbr)

    def body_onehot(pos):
        nbr = knn(pos)
        oh = jax.nn.one_hot(nbr, QN, dtype=traj0.dtype)    # (QN, K, QN)
        flat = traj0.reshape(QN, -1)
        obs = jnp.einsum("nko,of->nkf", oh, flat,
                         precision=jax.lax.Precision.HIGHEST)
        return lsc_from(obs.reshape(QN, K, *traj0.shape[1:]), pos, nbr)

    scan_time("lsc: knn gather (production)", body_gather, pos0)
    scan_time("lsc: static obstacles (no gather)", body_static, pos0)
    scan_time("lsc: one-hot matmul gather", body_onehot, pos0)


if __name__ == "__main__":
    main()

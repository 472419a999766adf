#!/usr/bin/env python
"""Diagnose the 1024-agent bench collision (BENCH_r02 min_safety=0.664).

Runs the exact bench configuration cycle by cycle and, for every cycle,
logs the argmin safety pair, their separation at plan time, the rank of
the partner in the ego agent's distance ordering (was it inside the
K-nearest neighbour set?), and both agents' QP primal residuals.
"""
import math
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsc_planner_tpu.runtime import enable_compilation_cache
enable_compilation_cache()
from lsc_planner_tpu.config import Param, GoalMode
from lsc_planner_tpu.missions import make_circle_mission
from lsc_planner_tpu.sim.simulator import SyncSimulator
from lsc_planner_tpu.sim import audit


def main(qn=1024, K=32, cycles=140, qp_iterations=14):
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    mission = make_circle_mission(qn, radius=radius,
                                  world=(-w, -w, 0, w, w, 2.5))
    param = Param(goal_mode=GoalMode.PRIOR_BASED,
                  qp_iterations=qp_iterations, max_neighbors=K)
    sim = SyncSimulator(mission, param, dtype=jnp.float32)
    state = sim.initial_state()

    ts = audit._sample_times(param.multisim_record_time_step,
                             param.multisim_time_step, inclusive=False)

    @jax.jit
    def diag(prev_pos, traj, primal_res):
        pos = audit.positions_at(traj, ts, param.dt)        # (T, N, 3)
        N = pos.shape[1]
        r = sim.radius
        dwc = sim.downwash
        r_sum = r[:, None] + r[None, :]
        dw = (dwc[:, None] * r[:, None] + dwc[None, :] * r[None, :]) / r_sum
        delta = pos[:, :, None, :] - pos[:, None, :, :]
        dist = jnp.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2 +
                        (delta[..., 2] / dw) ** 2)
        ratio = dist / r_sum
        eye = jnp.eye(N, dtype=bool)
        ratio = jnp.where(eye, jnp.inf, ratio)
        rmin_pair = jnp.min(ratio, axis=0)                  # (N, N)
        flat = jnp.argmin(rmin_pair)
        i, j = flat // N, flat % N
        # plan-time separation + neighbour rank of j for i
        d2 = jnp.sum((prev_pos[None] - prev_pos[:, None]) ** 2, axis=-1)
        d2 = jnp.where(eye, jnp.inf, d2)
        rank_ji = jnp.sum(d2[i] < d2[i, j])   # 0-based rank of j among i's
        rank_ij = jnp.sum(d2[j] < d2[j, i])
        return (jnp.min(rmin_pair), i, j, jnp.sqrt(d2[i, j]),
                rank_ji, rank_ij, primal_res[i], primal_res[j],
                jnp.max(primal_res))

    # row decoding for warm_row (factored path layout: static rows in
    # static_rows order, then plane rows c-major over (c, m, i))
    _, kinds = sim.optimizer.static_rows
    R_s = len(kinds)
    n1 = param.n + 1

    def row_desc(r):
        r = int(r)
        if r < R_s:
            kind, k, mseg = kinds[r]
            return f"static:{kind}[dim{k},m{mseg}]"
        r -= R_s
        c, rem = divmod(r, param.M * n1)
        mseg, ci = divmod(rem, n1)
        return f"plane[c{c},m{mseg},i{ci}]"

    worst = np.inf
    for it in range(cycles):
        prev_pos = state.pos
        state, info = sim._cycle_jit(state)
        m, i, j, d, rji, rij, pi, pj, pmax = jax.device_get(
            diag(prev_pos, state.traj, state.primal_res))
        if m < 1.02 or it % 10 == 0 or float(pmax) > 0.05:
            wr = np.asarray(info.warm_res)
            wrow = np.asarray(info.warm_row)
            wa = int(np.argmax(wr))
            print(f"cyc {it:3d} min_safety={float(m):.4f} pair=({int(i)},"
                  f"{int(j)}) plan_dist={float(d):.3f} "
                  f"rank(j in i)={int(rji)} rank(i in j)={int(rij)} "
                  f"primal=({float(pi):.2e},{float(pj):.2e}) "
                  f"primal_max={float(pmax):.2e} "
                  f"warm_max={wr[wa]:.2e}@a{wa}:{row_desc(wrow[wa])}",
                  flush=True)
        worst = min(worst, float(m))
        if sim.is_finished(state):
            print(f"finished at cycle {it}")
            break
    print(f"WORST min_safety = {worst:.4f}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--qn", type=int, default=1024)
    ap.add_argument("--K", type=int, default=32)
    ap.add_argument("--cycles", type=int, default=140)
    ap.add_argument("--qp-iterations", type=int, default=14)
    a = ap.parse_args()
    main(a.qn, a.K, a.cycles, a.qp_iterations)

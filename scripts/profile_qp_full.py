#!/usr/bin/env python
"""Time full solve_qp_lsc at production shapes (1024 agents, K=32+6)."""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from lsc_planner_tpu.config import Param
from lsc_planner_tpu.planner.optimizer import TrajOptimizer
from lsc_planner_tpu.ops import qp as qp_ops
from lsc_planner_tpu.runtime import exact_f32

N, C = 1024, 38
ITERS = 14


def main():
    opt = TrajOptimizer(Param())
    nv, nf, M, n1 = opt.nv, opt.nf, opt.M, opt.n + 1
    rng = np.random.default_rng(0)

    Lm = rng.normal(size=(N, nv, nv)).astype(np.float32) * 0.1
    P = Lm @ np.swapaxes(Lm, -1, -2) + 5.0 * np.eye(nv, dtype=np.float32)
    q = rng.normal(size=(N, nv)).astype(np.float32)
    b_st = (rng.normal(size=(N, opt.A_static_y.shape[0])) - 8.0).astype(
        np.float32)
    normal = rng.normal(size=(N, C, M, 3)).astype(np.float32)
    rhs = (rng.normal(size=(N, C, M, n1)) - 8.0).astype(np.float32)
    mask = rng.uniform(size=(N, C, M, n1)) > 0.2

    args = [jnp.asarray(P), jnp.asarray(q), jnp.asarray(opt.A_static_y),
            jnp.asarray(b_st), jnp.asarray(normal), jnp.asarray(rhs),
            jnp.asarray(mask), jnp.asarray(opt.F_seg)]

    for label, blocks in (("generic static rows", None),
                          ("blocked static rows", opt.static_blocked)):
        fn = jax.jit(exact_f32(lambda *a: qp_ops.solve_qp_lsc(
            *a, iters=ITERS, static_blocks=blocks)))
        sol = fn(*args)
        sol.y.block_until_ready()
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            sol = fn(*args)
        sol.y.block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        print(f"{label:28s} {dt*1e3:8.2f} ms   "
              f"({dt/ITERS*1e3:.3f} ms/iter)  finite="
              f"{bool(jnp.isfinite(sol.y).all())}")


if __name__ == "__main__":
    main()

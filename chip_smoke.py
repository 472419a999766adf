#!/usr/bin/env python
"""Prove that the swarm planning cycle runs on an NVIDIA GPU, phase by phase.

    python chip_smoke.py                # phases 0-5 on one card
    python chip_smoke.py --four-cards   # the sharded cycle on four cards,
                                        # and nothing else

Phases (one card):
  0  device gate: JAX's default device must be a GPU; prints jax's
     version, the device kind and the card's name and power limit
     (nvidia-smi).
  1  precision: audit.precision_self_check (audit sampling and the
     Bernstein rollout at 148 m coordinates, tolerance 1e-3 m).
  3  full-width swarm: bench.py's 1024-agent circle (K = 32 neighbours,
     prior-based goals, f32) through SyncSimulator for 30 cycles: 10 by
     `_cycle_jit`, then 2 x `make_scan_cycle(10)`.  Ends finite with
     safety_agent_min >= 1; prints compile seconds apart from steady
     per-cycle milliseconds (information, not a benchmark).
  2  kernels against plain references at real widths (runs after phase
     3, whose cycle 10 QP instance it captures): the factored IPM solve
     against a float64 solve, the batched Cholesky + substitutions at
     (1024, 39, 39) as a relative residual, and the wavefront field on
     phase 4's grid against the native A* oracle, exactly.
  4  obstacle world: a 20-agent mission among seeded static boxes folded
     into the ESDF (ESDF, SFC corridor, wavefront, descent and LOS all
     run on the card), to completion or a cycle cap, with no collision.
  5  whole-cycle parity: one 64-agent cycle from the same state in f32 on
     the GPU and in f64 on the CPU.

Phases 2 and 5 bound the GPU's f32 error against float64 by the CPU's:
a GPU f32 result may be at most 2x as far from the f64 result as the
CPU's f32 result of the same computation, plus 1e-4 m (both are f32
roundings of one fixed-iteration algorithm; the slack covers results
that agree to f32 resolution).  The float64 and CPU f32 references run
in a CPU-only child process (this script with --cpu-reference) that gets
its arrays through an .npz file in a temporary directory: only this
process opens the card, and x64 never enters the GPU program.

Any failed phase raises, so the script exits non-zero and prints no
result.  The last line of a passing run is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

--cpu-rehearsal runs the selected phases on JAX's CPU backend at reduced
sizes (a dry run of the control flow); it prints no result and exits 3.
"""
import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL_PRECISION_M = 1e-3       # audit.precision_self_check's tolerance
PARITY_FACTOR, PARITY_SLACK_M = 2.0, 1e-4
CHOL_RESID_TOL = 1e-5        # backward-stable: a few n * eps_f32
WORLD_10 = (-5.0, -5.0, 0.0, 5.0, 5.0, 2.5)


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def circle_param(max_neighbors, **kw):
    from lsc_planner_tpu.config import Param, GoalMode
    return Param(goal_mode=GoalMode.PRIOR_BASED,
                 max_neighbors=max_neighbors, **kw)


def circle_sim(qn, max_neighbors, dtype=None, **kw):
    """bench.py's circle: ~0.9 m arc spacing (radius 146.7 m at 1024)."""
    import jax.numpy as jnp
    from lsc_planner_tpu.missions import make_circle_mission
    from lsc_planner_tpu.sim.simulator import SyncSimulator
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    mission = make_circle_mission(qn, radius=radius,
                                  world=(-w, -w, 0, w, w, 2.5))
    return SyncSimulator(mission, circle_param(max_neighbors, **kw),
                         dtype=dtype or jnp.float32)


def forest_mission(qn, seed=3, n_boxes=14):
    """Random swaps among seeded box trunks (0.3-0.5 m wide, full
    height) in a 10 x 10 x 2.5 m world, every start and goal >= 0.8 m
    from every trunk: the reference's testall forest size, generated."""
    from lsc_planner_tpu.missions import ObstacleSpec, make_random_mission
    m = make_random_mission(qn, world=WORLD_10, seed=seed, min_dist=0.8)
    ends = np.array([a.start[:2] for a in m.agents] +
                    [a.goal[:2] for a in m.agents])
    rng = np.random.default_rng(seed)
    boxes = []
    while len(boxes) < n_boxes:
        c = rng.uniform(-4.0, 4.0, size=2)
        half = rng.uniform(0.15, 0.25, size=2)
        gap = np.max(np.abs(ends - c) - half, axis=1)   # Chebyshev gap
        if gap.min() > 0.8:
            boxes.append(ObstacleSpec(
                kind="static", pose=np.array([c[0], c[1], 1.25]),
                dimensions=np.array([half[0], half[1], 1.25])))
    return dataclasses.replace(m, obstacles=boxes)


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) -
                               np.asarray(b, np.float64))))


def parity(name, got, ref64, yard, labels=("gpu f32", "cpu f32")):
    """Check |got - f64| <= 2 |yard - f64| + 1e-4 (metres)."""
    e_got, e_yard = max_err(got, ref64), max_err(yard, ref64)
    bound = PARITY_FACTOR * e_yard + PARITY_SLACK_M
    log(f"  {name}: |{labels[0]} - f64| = {e_got:.3e} m, |{labels[1]} - "
        f"f64| = {e_yard:.3e} m, bound {bound:.3e} m (= {PARITY_FACTOR:g} "
        f"x {labels[1]} + {PARITY_SLACK_M:g})")
    check(e_got <= bound, f"{name}: {labels[0]} error {e_got:.3e} m "
                          f"exceeds {bound:.3e} m")


# ----------------------------------------------------------------------
# CPU-only child: float64 and f32 references
# ----------------------------------------------------------------------

def cpu_reference(task, arrays, wait=True):
    """Run `task` in a CPU-only child process of this script; arrays in
    and out through .npz files.  wait=False returns a function that
    waits for the result, so the card keeps working meanwhile."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    src = os.path.join(tmp, "in.npz")
    np.savez(src, task=np.asarray(task), **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_PYTHON_CLIENT_MEM_FRACTION", None)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--cpu-reference", src], env=env)

    def result():
        try:
            if proc.wait() != 0:
                raise RuntimeError(f"CPU reference '{task}' failed "
                                   f"(exit {proc.returncode})")
            with np.load(os.path.join(tmp, "out.npz")) as f:
                return dict(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return result() if wait else result


def run_cpu_reference(src):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from lsc_planner_tpu.runtime import exact_f32
    with np.load(src) as f:
        inp = dict(f)
    task = str(inp.pop("task"))
    out = {}
    if task == "qp":
        sim = circle_sim(int(inp["qn"]), int(inp["max_neighbors"]))
        solve = qp_solver(sim)
        for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
            args = [jnp.asarray(inp[k], dt) if inp[k].dtype.kind == "f"
                    else jnp.asarray(inp[k]) for k in QP_KEYS]
            out[name] = np.asarray(solve(*args).y)
    elif task == "cycle":
        for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
            sim = circle_sim(int(inp["qn"]), int(inp["max_neighbors"]),
                             dtype=dt, qp_tol_gap=0.0, qp_tol_rp=0.0)
            state = load_state(inp, dt)
            new, _ = jax.jit(exact_f32(sim._cycle))(state)
            out[name] = np.asarray(new.traj)
    else:
        raise SystemExit(f"unknown task {task}")
    np.savez(os.path.join(os.path.dirname(src), "out.npz"), **out)


def save_state(state):
    return {f"state_{k}": np.asarray(v) for k, v in state._asdict().items()}


def load_state(arrays, dtype):
    import jax.numpy as jnp
    from lsc_planner_tpu.sim.simulator import SwarmState
    fields = {}
    for k in SwarmState._fields:
        v = arrays[f"state_{k}"]
        fields[k] = jnp.asarray(v, dtype if v.dtype.kind == "f" else None)
    return SwarmState(**fields)


QP_KEYS = ("P", "q", "A_st", "b_st", "normal", "rhs", "mask", "F_seg", "y0")
QP_ITERS = 20                # fixed: every tolerance 0, no early exit


def qp_solver(sim):
    """The production factored solve with a fixed iteration count,
    jitted under the cycle's precision policy."""
    import jax
    from lsc_planner_tpu.ops import qp
    from lsc_planner_tpu.runtime import exact_f32
    p = sim.param

    def solve(P, q, A_st, b_st, normal, rhs, mask, F_seg, y0):
        return qp.solve_qp_lsc(
            P, q, A_st, b_st, normal, rhs, mask, F_seg, y0=y0,
            iters=QP_ITERS, s_min=p.qp_s_min, tol_gap=0.0, tol_rp=0.0,
            tol_rd=0.0, correctors=p.qp_correctors,
            static_blocks=sim.optimizer.static_blocked)
    return jax.jit(exact_f32(solve))


def capture_qp_instance(sim, state):
    """The solve_qp_lsc inputs of one production cycle from `state`."""
    import jax
    from lsc_planner_tpu.ops import qp
    from lsc_planner_tpu.runtime import exact_f32
    orig = qp.solve_qp_lsc

    def traced(st):
        box = {}

        def grab(*a, **k):
            box["a"], box["k"] = a, k
            return orig(*a, **k)
        qp.solve_qp_lsc = grab
        try:
            sim._cycle(st)
        finally:
            qp.solve_qp_lsc = orig
        check("a" in box, "the cycle took the dense-row QP path; the "
                          "factored path needs > 48 MB of dense rows")
        a = box["a"]
        return dict(P=a[0], q=a[1], b_st=a[3], normal=a[4], rhs=a[5],
                    mask=a[6], y0=box["k"]["y0"])
    inst = {k: np.asarray(v) for k, v in
            jax.jit(exact_f32(traced))(state).items()}
    inst["A_st"] = np.asarray(sim.optimizer.A_static_y, np.float32)
    inst["F_seg"] = np.asarray(sim.optimizer.F_seg, np.float32)
    return inst


# ----------------------------------------------------------------------
# one-card phases
# ----------------------------------------------------------------------

def phase1_precision():
    from lsc_planner_tpu.sim import audit
    errs = audit.precision_self_check(tol=TOL_PRECISION_M)
    for name, err in errs.items():
        log(f"phase 1 precision: {name} max error {err:.3e} m <= tol "
            f"{TOL_PRECISION_M:g} m (f32, matmul precision highest)")


def phase3_swarm(qn, kind):
    sim = circle_sim(qn, 32)
    state = sim.initial_state()
    overflow, iters = 0, []
    times = []
    for i in range(10):
        t0 = time.perf_counter()
        state, info = sim._cycle_jit(state)
        state.traj.block_until_ready()
        times.append(time.perf_counter() - t0)
        overflow = max(overflow, int(np.asarray(info.knn_overflow).sum()))
        iters.append(int(info.qp_iters))
    state10 = state
    multi = sim.make_scan_cycle(10)
    scan_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, (info, _, _) = multi(state)
        state.traj.block_until_ready()
        scan_times.append(time.perf_counter() - t0)
        overflow = max(overflow, int(np.asarray(info.knn_overflow).sum(
            axis=-1).max()))
        iters += [int(v) for v in np.asarray(info.qp_iters)]
    safety = float(state.safety_agent_min)
    finite = bool(np.isfinite(np.asarray(state.traj)).all())
    log(f"phase 3 swarm: {qn} agents, K=32, f32, 30 cycles on {kind}: "
        f"safety_agent_min {safety:.4f} (>= 1), finite {finite}, "
        f"knn_overflow max {overflow} agents/cycle, QP iters per cycle "
        f"{iters}")
    log(f"phase 3 timing on {kind} (information, not a benchmark): "
        f"_cycle_jit first call (compile + 1 cycle) {times[0]:.2f} s, "
        f"steady {1e3 * float(np.median(times[1:])):.2f} ms/cycle; "
        f"scan(10) first call (compile + 10 cycles) {scan_times[0]:.2f} s, "
        f"steady {1e3 * scan_times[1] / 10:.2f} ms/cycle")
    check(finite, "phase 3: non-finite trajectories")
    check(safety >= 1.0, f"phase 3: safety_agent_min {safety} < 1")
    return sim, state10


def phase2_kernels(sim, state10, sim4, rehearsal):
    import jax
    import jax.numpy as jnp
    from lsc_planner_tpu import native
    from lsc_planner_tpu.ops import qp
    from lsc_planner_tpu.runtime import exact_f32

    # (a) the factored IPM on a captured production instance
    inst = capture_qp_instance(sim, state10)
    y_gpu = np.asarray(qp_solver(sim)(*[jnp.asarray(inst[k])
                                        for k in QP_KEYS]).y)
    ref = cpu_reference("qp", dict(inst, qn=np.asarray(sim.N),
                                   max_neighbors=np.asarray(
                                       sim.param.max_neighbors)))
    log(f"phase 2a factored IPM: captured cycle-10 instance, "
        f"N={inst['P'].shape[0]}, nv={inst['P'].shape[-1]}, "
        f"{inst['b_st'].shape[1] + inst['rhs'][0].size} rows/agent, "
        f"{QP_ITERS} fixed iterations, y in m")
    check(np.isfinite(y_gpu).all(), "phase 2a: non-finite GPU solve")
    parity("phase 2a y", y_gpu, ref["f64"], ref["f32"])
    # the f32 solves differ from f64 mostly along the cost's weakest
    # directions; their f64-evaluated objective excess shows how little
    P, q = inst["P"].astype(np.float64), inst["q"].astype(np.float64)

    def obj(y):
        return (0.5 * np.einsum("nv,nvw,nw->n", y, P, y) +
                np.einsum("nv,nv->n", q, y))
    o64 = obj(ref["f64"])
    for name, y in (("gpu f32", y_gpu), ("cpu f32", ref["f32"])):
        rel = (obj(np.asarray(y, np.float64)) - o64) / np.abs(o64)
        log(f"  phase 2a objective excess over f64, {name}: max "
            f"{rel.max():.3e} relative (information)")

    # (b) batched Cholesky + substitutions, seeded SPD systems shaped
    #     like the IPM's Jacobi-equilibrated normal equations
    B, n = (64 if rehearsal else 1024), 39
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    H = np.einsum("bij,j,bkj->bik", Q, np.logspace(-4, 0, n), Q)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", H))
    H = H * d[:, :, None] * d[:, None, :]
    r = rng.normal(size=(B, n))

    def factor_solve(Hs, rhs):
        L = qp._cholesky(Hs)
        return L, qp._chol_solve(L, rhs)
    L, x = jax.jit(exact_f32(factor_solve))(jnp.asarray(H, jnp.float32),
                                            jnp.asarray(r, jnp.float32))
    L, x = np.asarray(L, np.float64), np.asarray(x, np.float64)
    resid = (np.linalg.norm(np.einsum("bij,bj->bi", H, x) - r, axis=1) /
             (np.linalg.norm(H, 2, axis=(1, 2)) * np.linalg.norm(x, axis=1)))
    recon = (np.linalg.norm(L @ np.swapaxes(L, -1, -2) - H, axis=(1, 2)) /
             np.linalg.norm(H, axis=(1, 2)))
    log(f"phase 2b cholesky+solve ({B}, {n}, {n}) f32, cond ~1e4: "
        f"relative residual {resid.max():.3e}, reconstruction "
        f"{recon.max():.3e}, both <= tol {CHOL_RESID_TOL:g} (f64 numpy "
        f"reference)")
    check(resid.max() <= CHOL_RESID_TOL and recon.max() <= CHOL_RESID_TOL,
          "phase 2b: batched Cholesky residual above tolerance")

    # (c) wavefront field on phase 4's grid vs the native A* oracle.
    #     A* stops anywhere in the goal column, so the column is walled
    #     off except the goal cell: path cost = shortest distance.
    check(native.load() is not None, "phase 2c: native A* unavailable "
                                     "(g++ build failed)")
    gp = sim4.goal_planner.grid_planner
    occ = np.asarray(gp.static_occupancy(float(sim4.mission.agents[0]
                                               .radius)))
    free = np.argwhere(~occ)
    goals = free[rng.choice(len(free), 8, replace=False)]
    occs = np.repeat(occ[None], len(goals), axis=0)
    for o, g in zip(occs, goals):
        o[g[0], g[1], :] = True
        o[tuple(g)] = False
    D = np.asarray(jax.jit(jax.vmap(gp.wavefront))(
        jnp.asarray(occs), jnp.asarray(goals, jnp.int32)))
    compared = mismatched = unreachable = 0
    for o, g, Dg in zip(occs, goals, D):
        cells = np.argwhere(~o)
        for s in cells[rng.choice(len(cells), 24, replace=False)]:
            path = native.astar6(o, s, g)
            cost = len(path) - 1.0 if len(path) else np.inf
            if cost > gp.max_wavefront_iters:
                cost = np.inf             # beyond the scan's length
            unreachable += int(np.isinf(cost))
            compared += 1
            mismatched += int(Dg[tuple(s)] != cost)
    log(f"phase 2c wavefront: grid {tuple(int(v) for v in gp.dims)}, "
        f"{len(goals)} goals x "
        f"24 starts = {compared} A* paths ({unreachable} unreachable), "
        f"{mismatched} mismatches (exact integer costs required, f32)")
    check(mismatched == 0, "phase 2c: wavefront distance != A* cost")


def phase4_mission(sim4, cap):
    summary = sim4.run(max_iterations=cap)
    finished = summary["iterations"] < cap or \
        np.isfinite(summary["total_flight_time"])
    log(f"phase 4 obstacle world: {sim4.N} agents, "
        f"{sim4.static_boxes.shape[0]} static boxes in the ESDF, "
        f"{summary['iterations']} cycles (cap {cap}), finished {finished}, "
        f"collided {summary['is_collided']}, safety agent "
        f"{summary['safety_ratio_agent']:.4f} / static boxes "
        f"{summary['safety_ratio_obs']:.4f} (>= 1), qp_failures "
        f"{summary['qp_failures']}, mean cycle "
        f"{1e3 * summary['average_planning_time']:.2f} ms (information)")
    check(not summary["is_collided"], "phase 4: collision")
    check(summary["safety_ratio_agent"] >= 1.0 and
          summary["safety_ratio_obs"] >= 1.0, "phase 4: safety ratio < 1")


def phase5_cycle_parity(qn):
    sim = circle_sim(qn, -1, qp_tol_gap=0.0, qp_tol_rp=0.0)
    state = sim.initial_state()
    for _ in range(15):
        state, _ = sim._cycle_jit(state)
    new, _ = sim._cycle_jit(state)
    ref = cpu_reference("cycle", dict(save_state(state), qn=np.asarray(qn),
                                      max_neighbors=np.asarray(-1)))
    log(f"phase 5 whole-cycle parity: {qn} agents, cycle 16 from one "
        f"state, fixed QP iterations, trajectory control points in m")
    parity("phase 5 traj", new.traj, ref["f64"], ref["f32"])


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------

def phase_four_cards(rehearsal):
    import jax
    from lsc_planner_tpu.parallel import shard as pshard
    from lsc_planner_tpu.config import Param, GoalMode
    from lsc_planner_tpu.missions import make_lane_mission
    from lsc_planner_tpu.sim.simulator import SyncSimulator
    check(len(jax.devices()) == 4, f"--four-cards needs 4 devices, found "
                                   f"{len(jax.devices())}")
    mesh = pshard.make_mesh(4)
    big, mid = (64, 32) if rehearsal else (4096, 1024)

    # parity first: its f64 reference runs on the CPU while the cards
    # work on the other parts
    sim_p = circle_sim(mid, 32, qp_tol_gap=0.0, qp_tol_rp=0.0)
    state = sim_p.initial_state()
    for _ in range(10):
        state, _ = sim_p._cycle_jit(state)
    one, _ = sim_p._cycle_jit(state)
    pending = cpu_reference("cycle", dict(save_state(state),
                                          qn=np.asarray(mid),
                                          max_neighbors=np.asarray(32)),
                            wait=False)
    cyc_p = pshard.make_sharded_cycle(sim_p, mesh)
    four, _ = cyc_p(pshard.shard_state(state, mesh))

    # (a) all_gather cycle at full width, agents spread over the cards
    sim = circle_sim(big, 32)
    cycle = pshard.make_sharded_cycle(sim, mesh)
    st = pshard.shard_state(sim.initial_state(), mesh)
    t0 = time.perf_counter()
    st, info = cycle(st)
    st.traj.block_until_ready()
    t_first = time.perf_counter() - t0
    step_min = [float(info.safety_step_min)]
    t0 = time.perf_counter()
    for _ in range(4):
        st, info = cycle(st)
        step_min.append(float(info.safety_step_min))
    st.traj.block_until_ready()
    t_steady = (time.perf_counter() - t0) / 4
    placement = sorted((s.device.id, s.data.shape[0])
                       for s in st.traj.addressable_shards)
    log(f"four cards (a) all_gather cycle: {big} agents, K=32, 5 cycles, "
        f"per-card agents {placement} (device id, agents), per-cycle "
        f"min safety {[round(v, 4) for v in step_min]}, running min "
        f"{float(st.safety_agent_min):.4f} (>= 1); first call "
        f"{t_first:.2f} s, steady {1e3 * t_steady:.2f} ms/cycle "
        f"(information)")
    check(len({d for d, _ in placement}) == 4 and
          all(n == big // 4 for _, n in placement),
          f"four cards (a): agents not spread over 4 cards: {placement}")
    check(np.isfinite(np.asarray(st.traj)).all(), "four cards (a): NaN")
    check(float(st.safety_agent_min) >= 1.0, "four cards (a): collision")

    # (c) ring halo H=1 with a spatial re-sort every cycle (lane swaps)
    lanes = make_lane_mission(mid, lane_gap=2.0, length=6.0)
    sim_l = SyncSimulator(lanes, Param(goal_mode=GoalMode.PRIOR_BASED,
                                       max_neighbors=4))
    cyc_h = pshard.make_sharded_cycle(sim_l, mesh, halo_shards=1)
    wmin, wmax = lanes.world_min, lanes.world_max
    sort = jax.jit(lambda s: pshard.spatial_sort_state(s, wmin, wmax,
                                                        key="axis:1"))
    st = pshard.shard_state(sim_l.initial_state(), mesh)
    halo_min = []
    for _ in range(5):
        st = sort(st)
        st, info = cyc_h(st)
        halo_min.append(float(info.safety_step_min))
    log(f"four cards (c) ring halo H=1 + spatial sort: {mid} agents in "
        f"{mid // 2} lanes, 5 cycles, per-cycle min safety "
        f"{[round(v, 4) for v in halo_min]} (>= 1)")
    check(np.isfinite(np.asarray(st.traj)).all(), "four cards (c): NaN")
    check(min(halo_min) >= 1.0, "four cards (c): collision")

    # (b) parity: the 4-card cycle vs the 1-card cycle from one state
    ref = pending()
    log(f"four cards (b) parity: {mid} agents, cycle 11 from one state, "
        f"fixed QP iterations; the 1-card GPU cycle is the yardstick "
        f"in place of the CPU f32 cycle, trajectory control points in m")
    log(f"  |4-card - 1-card| = {max_err(four.traj, one.traj):.3e} m")
    parity("four cards (b) traj", four.traj, ref["f64"], one.traj,
           labels=("4-card f32", "1-card f32"))


# ----------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded cycle on four cards")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="dry run on the CPU at reduced sizes; no result")
    ap.add_argument("--cpu-reference", metavar="NPZ",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_reference:
        return run_cpu_reference(args.cpu_reference)

    import jax
    from lsc_planner_tpu.runtime import (enable_compilation_cache,
                                         gpu_device_info)
    enable_compilation_cache()
    if args.cpu_rehearsal:
        dev0 = jax.devices()[0]
        device = {"platform": dev0.platform, "kind": dev0.device_kind,
                  "count": len(jax.devices()), "nvidia_smi": []}
    else:
        device = gpu_device_info()        # exits non-zero without a GPU
    log(f"phase 0 device: jax {jax.__version__}, platform "
        f"{device['platform']}, device_kind {device['kind']}, count "
        f"{device['count']}")
    for line in device["nvidia_smi"]:
        log(f"card (nvidia-smi name, power.limit): {line}")
    kind = f"{device['kind']}" + (f" ({device['nvidia_smi'][0]})"
                                  if device["nvidia_smi"] else "")

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(args.cpu_rehearsal)
    else:
        from lsc_planner_tpu.sim.simulator import SyncSimulator
        phase1_precision()
        # rehearsal: the smallest circle whose K=32 rows take the
        # factored QP path that phase 2a captures
        sim, state10 = phase3_swarm(384 if args.cpu_rehearsal else 1024,
                                    kind)
        sim4 = SyncSimulator(forest_mission(20), circle_param(-1))
        phase2_kernels(sim, state10, sim4, args.cpu_rehearsal)
        phase4_mission(sim4, cap=40 if args.cpu_rehearsal else 400)
        phase5_cycle_parity(16 if args.cpu_rehearsal else 64)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    if args.cpu_rehearsal:
        log("cpu rehearsal: no result (not an accelerator run)")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

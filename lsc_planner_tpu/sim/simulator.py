"""Synchronous multi-agent replanning simulator, batched on device.

Re-design of MultiSyncSimulator (src/multi_sync_simulator.cpp): the
reference's per-cycle sequence -- step clock, propagate ideal states,
exchange obstacle info, plan each agent sequentially, audit collisions,
log -- becomes one jitted tensor program over the whole swarm per cycle,
with a thin host loop for termination/metrics/CSV.

The reference's "communication step" (update() collecting every agent's
previous trajectory into per-agent ObstacleArrays,
multi_sync_simulator.cpp:269-303) is here a broadcast of the shared
(N, M, n+1, 3) control-point tensor; across devices it is an all_gather
over the agent-sharded mesh (parallel/shard.py) instead of ROS TCP.  The
cycle body is factored as `plan_block` -- a block of local agents
planning against the global obstacle view -- so single-chip (block = all)
and sharded execution share the same code path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Param, PlannerMode, GoalMode, SP_EPSILON
from ..missions import Mission
from ..ops import bernstein as bz
from . import audit
from ..planner import constraints as cons
from ..planner import prediction as pred
from ..planner import goal as goal_mod
from ..planner.optimizer import TrajOptimizer
from ..runtime import exact_f32


class SwarmState(NamedTuple):
    """Device-side swarm state carried across planning cycles.

    Leading axis of the per-agent fields is shardable over the mesh's
    agent axis.
    """
    traj: jnp.ndarray          # (N, M, n+1, 3) current solutions
    pos: jnp.ndarray           # (N, 3)
    vel: jnp.ndarray           # (N, 3)
    acc: jnp.ndarray           # (N, 3)
    current_goal: jnp.ndarray  # (N, 3)
    seq: jnp.ndarray           # () int32 planner sequence number
    qp_cost: jnp.ndarray       # (N,)
    primal_res: jnp.ndarray    # (N,) constraint violation of last QP
    safety_agent_min: jnp.ndarray  # () running min inter-agent safety ratio
    distance: jnp.ndarray      # () running total flight distance
    sfc: jnp.ndarray           # (N, M, 6) SFC boxes [min, max] per segment
    sfc_initialized: jnp.ndarray  # (N,) bool (flag_initialize_sfc analog)
    start: jnp.ndarray         # (N, 3) mission start (patrol swaps)
    desired_goal: jnp.ndarray  # (N, 3) mission goal (patrol/services)
    safety_obs_min: jnp.ndarray    # () running min agent-obstacle ratio
    stall_count: jnp.ndarray   # (N,) consecutive low-velocity cycles
    # (deadlock_start_seq bookkeeping analog, traj_planner.cpp:396-409)
    rescue_goal: jnp.ndarray   # (N, 3) latched deadlock-escape waypoint
    rescue_active: jnp.ndarray  # (N,) bool
    rescue_phase: jnp.ndarray  # (N,) int32 escalation phase (90/180/270)
    # disturbance-reset marks from the last pose injection
    # (obs_slack_indices analog, traj_planner.cpp:866-878): consumed by
    # the next cycle's slack-relaxed QP, then cleared (the reference
    # rebuilds the set per cycle from the prediction checks)
    slack_flags: jnp.ndarray = None   # (N,) bool
    # grid-path escape point from the last goal-planning pass (N, 3):
    # the rescue's first escape candidate (consecutive path cells are
    # axis-adjacent free cells, so steering along them is always
    # SFC-coverable where a LOS shortcut through a diagonal gap is not)
    path_floor: jnp.ndarray = None
    # per-agent best-ever distance to the desired goal (N,): the
    # progress watermark for stall/rescue escalation; reset to +inf
    # when the desired goal changes (patrol swap / goal update)
    best_goal_dist: jnp.ndarray = None


class CycleInfo(NamedTuple):
    safety_step_min: jnp.ndarray
    qp_cost: jnp.ndarray
    primal_res: jnp.ndarray
    warm_res: jnp.ndarray = None   # (N,) warm-start max row violation
    warm_row: jnp.ndarray = None   # (N,) argmax row index of the above
    qp_failed: jnp.ndarray = None  # (N,) bool QPFAILED report
    knn_overflow: jnp.ndarray = None  # (N,) bool K-NN density audit
    qp_iters: jnp.ndarray = None   # () IPM iterations consumed:
                                   # exit-fired observability


def _update_stall_count(prev_count, best_prev, prev_pos, pos, vel,
                        desired_goal, seq, p, has_static=False):
    """Stall counter with progress hysteresis (shared by the single-chip
    and sharded cycles).  +1 while stalled; -1 (decay, not reset) while
    moving without closing on the goal; reset to 0 only on cycle-over-
    cycle progress or arrival.

    TWO progress signals are returned:
    * `progress` (plain, cycle-over-cycle): drives stall counting and
      rescue release.  It must stay the permissive signal -- making it
      stricter fires rescue pushes inside congested (empty-world)
      crowds, where dragged agents ride their LSC boundaries at the f32
      solver slop and the safety audit records ~0.993 ratios (observed
      on the 60-agent empty corpus).
    * `progress_best` (watermark: beating the best-ever goal distance
      best_prev): drives ONLY the rescue phase ladder.  Plain progress
      during a push-back recovery otherwise resets the ladder and locks
      an approach/stall/push-back limit cycle (observed on
      multi_square16 agent 13).  The caller resets best_prev to +inf
      when the desired goal changes (patrol swap / goal update).

    Returns (count, progress, progress_best, best)."""
    dist = jnp.linalg.norm(pos - desired_goal, axis=-1)
    prev_dist = jnp.linalg.norm(prev_pos - desired_goal, axis=-1)
    progress = (prev_dist - dist) > p.deadlock_progress_eps
    progress_best = (best_prev - dist) > p.deadlock_progress_eps
    best = jnp.minimum(best_prev, dist)
    stalled = ((jnp.linalg.norm(vel, axis=-1)
                < p.deadlock_velocity_threshold) &
               (dist > p.goal_threshold) & (seq > 0))
    # Reset on plain cycle-over-cycle progress (the permissive signal;
    # see docstring).  A watermark-based reset and a slow increment for
    # moving-but-stagnant agents were both tried in round 5 against the
    # multi_square16 knots and measured NEUTRAL (162 -> 162) and WORSE
    # (162 -> 173 cycles) respectively: the knots are a corridor-
    # mobility phenomenon, and engaging the rescue excursion earlier
    # only adds round trips.  has_static is accepted (and ignored) so
    # callers stay uniform.
    del has_static
    reset = progress | (dist <= p.goal_threshold)
    count = jnp.where(reset, 0,
                      jnp.where(stalled, prev_count + 1,
                                jnp.maximum(prev_count - 1, 0)))
    return count, progress, progress_best, best


def _update_rescue(state, pos, desired_goal, stall_count, progress, p,
                   esdf=None, radius=None, world_min=None, world_max=None,
                   progress_best=None):
    """Latched deadlock-escape waypoints (extension beyond the reference,
    which leaves forest pocket deadlocks to chance -- README.md:75).

    When the stall count crosses the threshold, freeze an escape waypoint
    and chase it INSTEAD of the planner subgoal until it is reached or the
    agent makes real progress toward its desired goal.  A latched waypoint
    (vs. re-deriving the push every cycle) is what prevents the
    stall/rescue tug-of-war: the normal subgoal cannot pull the agent
    straight back into the pocket while the escape is in flight.  Each
    re-engagement without intervening progress rotates the escalation
    phase, so no single blocked direction traps an agent.

    Candidate directions per engagement: FIRST the grid-path escape
    point from the last goal-planning pass (path_floor) -- a stall
    usually means the LOS sub-goal points through a gap the axis-aligned
    SFC expansion cannot cover (observed on multi_square16: agents park
    against a 0.3 m-clearance diagonal gap for dozens of cycles), and
    the grid path is by construction a cell-adjacent detour the corridor
    CAN follow -- then the goal direction rotated by 90/270/180 degrees
    about z, plus straight up (forest pockets usually open upward).
    With a static world (esdf), each candidate's straight ray from the
    agent is validated against the ESDF and the first admissible one
    starting from the escalation phase is taken -- a blind rotation can
    latch a waypoint INSIDE a tree, which the agent chases fruitlessly
    for `deadlock_seq_threshold` cycles per phase (observed on
    multi_square16 + simple_forest).

    A latched waypoint can still be unreachable (outside the agent's
    collapsed SFC), so an active rescue EXPIRES when the stall count
    re-crosses the threshold: engagement resets the count, and if the
    agent is still stalled `deadlock_seq_threshold` cycles later the
    waypoint is abandoned and the phase rotates.  Without this the first
    unreachable waypoint latches forever and the escalation dies.

    Returns (rescue_goal, rescue_active, rescue_phase, stall_count).
    """
    path_floor = state.path_floor
    n_cand = 4 if path_floor is None else 5
    reached = (jnp.linalg.norm(pos - state.rescue_goal, axis=-1)
               < p.goal_threshold) & state.rescue_active
    # phase resets ONLY on WATERMARK progress (progress_best).  Plain
    # progress or "reached the waypoint" is not success by itself: a
    # valid-but-backward candidate always "succeeds" at being reached
    # and earns ~10 cycles of plain progress on the way back, and
    # resetting the ladder there locks an approach/retreat orbit in
    # which the later candidates (e.g. straight up) are never tried
    # (observed on multi_square16 agent 13).  A strategy that beats the
    # best-ever goal distance resets to the path-floor rung, letting
    # successful floor hops chain cell-by-cell through a gap.  Release
    # (active) stays on plain progress -- the old, permissive signal --
    # so rescue engagement dynamics in congested crowds are unchanged.
    if progress_best is None:
        progress_best = progress
    phase = jnp.where(progress_best, 0, state.rescue_phase)
    active = state.rescue_active & ~progress & ~reached

    gdir = desired_goal - pos
    gnorm = jnp.linalg.norm(gdir, axis=-1, keepdims=True)
    # excursion cap: a failed ladder rung costs a round trip at crawl
    # speed, so waypoints at goal_radius (2 m) burn ~35 cycles each
    # before the next candidate gets tried; 1 m is enough displacement
    # to clear a pocket and halves the cost of a wrong guess
    reach = jnp.minimum(gnorm, jnp.asarray(1.0, pos.dtype))   # (N, 1)

    over = stall_count > p.deadlock_seq_threshold
    # An ACTIVE rescue whose agent is still fully immobile has latched an
    # unreachable rung; waiting the full engagement threshold again just
    # parks the agent (measured 6 wasted cycles per dead rung on the
    # multi_square16 knots).  Expire it on a shorter clock -- a rung that
    # actually moves the agent keeps velocity above the stall threshold
    # and never trips this.
    over_r = stall_count > p.rescue_expire_cycles
    expire = active & over_r
    active = active & ~expire
    phase_start = phase % n_cand          # 0-based first candidate to try
    # Never engage NEAR the goal: the receding-horizon final approach is
    # an exponential tail whose velocity sits below the stall threshold
    # for most of the last ~0.5 m (the terminal-weight/jerk balance; the
    # reference's closed loop has the same tail), and a rescue waypoint
    # there (reach ~ gd, rotated) drags the agent away from a goal
    # nothing blocks -- observed as permanent hovers on the forest and
    # circle endgames.  True blockage that close is the priority
    # back-away rule's job, not the rescue's.
    far = gnorm[..., 0] > 0.5 * p.goal_radius
    engage = (over | expire) & ~active & far
    stall_count = jnp.where(engage, 0, stall_count)

    dirs = []
    for k in range(1, 4):                                     # rotations
        theta = jnp.asarray((jnp.pi / 2.0) * k, pos.dtype)
        c, s = jnp.cos(theta), jnp.sin(theta)
        rot = jnp.stack([c * gdir[..., 0] + s * gdir[..., 1],
                         -s * gdir[..., 0] + c * gdir[..., 1],
                         gdir[..., 2]], axis=-1)
        dirs.append(rot / jnp.maximum(
            jnp.linalg.norm(rot, axis=-1, keepdims=True), 1e-12))
    up = jnp.zeros_like(pos).at[..., 2].set(1.0)
    dirs.append(up)
    cands = jnp.stack([pos + d * reach for d in dirs], axis=-2)  # (N,4,3)
    floor_ok = None
    if path_floor is not None:
        # grid-path escape first: only a real detour counts (the floored
        # path degenerates to the agent's own cell at/near the goal)
        cands = jnp.concatenate([path_floor[..., None, :], cands],
                                axis=-2)                      # (N, 5, 3)
        floor_vec = path_floor - pos
        floor_norm = jnp.linalg.norm(floor_vec, axis=-1)
        floor_ok = floor_norm > 0.3
        # A stall means the direction the agent was chasing is blocked
        # for the QP.  The grid-path floor only helps when it is a real
        # DETOUR; when it points the same way as the goal it just
        # stalled against (straight grid path), latching it freezes the
        # agent for another expiry period (measured on both
        # multi_square16 knot episodes).  Skip collinear floors and go
        # straight to the rotated candidates.  state.current_goal is the
        # goal chased LAST cycle: the planner sub-goal before a fresh
        # engagement, or the abandoned waypoint on an expiry rotation --
        # both exactly the direction that just failed.
        sub_vec = state.current_goal - pos
        denom = jnp.maximum(
            floor_norm * jnp.linalg.norm(sub_vec, axis=-1), 1e-9)
        cosang = jnp.sum(floor_vec * sub_vec, axis=-1) / denom
        floor_ok = floor_ok & (cosang < 0.8)
    if world_min is not None:
        r_c = radius[..., None, None]
        cands = jnp.clip(cands, world_min + r_c, world_max - r_c)

    if esdf is not None and radius is not None:
        # straight-ray admissibility against the static world; the
        # threshold is clamped to just under the agent's own clearance so
        # a sub-margin pocket (where every ray fails at t=0) still
        # rotates through candidates instead of freezing
        S = 9
        t = jnp.linspace(0.0, 1.0, S).astype(pos.dtype)
        ray = pos[..., None, None, :] + \
            (cands - pos[..., None, :])[..., None, :] * \
            t[None, None, :, None]                         # (N, C, S, 3)
        min_clear = jnp.min(esdf.at_points(ray), axis=-1)  # (N, C)
        own_clear = esdf.at_points(pos)[..., None]         # (N, 1), = t=0
        thr = jnp.minimum(radius[..., None] + 0.5 * p.world_resolution,
                          own_clear - 1e-3)
        valid = min_clear > thr
    else:
        valid = jnp.ones(cands.shape[:-1], bool)
    if floor_ok is not None:
        valid = valid.at[..., 0].set(valid[..., 0] & floor_ok)

    # first valid candidate at-or-after the escalation phase (cyclic);
    # fall back to the phase's raw candidate when none validates.  The
    # recorded phase is the index of the candidate ACTUALLY latched
    # (+1, 1-based), not the tentative start -- otherwise an invalid
    # skipped candidate (e.g. a degenerate path_floor) makes two phases
    # resolve to the same physical waypoint and the escalation wastes a
    # full expiry period re-trying it.
    idx0 = phase_start[..., None]                           # (N, 1)
    order = (jnp.arange(n_cand)[None, :] - idx0) % n_cand
    score = jnp.where(valid, order, n_cand + order)
    pick = jnp.argmin(score, axis=-1)                       # (N,)
    waypoint = jnp.take_along_axis(
        cands, pick[..., None, None].repeat(3, -1), axis=-2)[..., 0, :]
    rescue_goal = jnp.where(engage[..., None], waypoint, state.rescue_goal)
    phase_new = jnp.where(engage, (pick + 1).astype(phase.dtype),
                          phase)                            # 1..n_cand
    return rescue_goal, active | engage, phase_new, stall_count


def _no_rescue(state):
    return state.rescue_goal, jnp.zeros_like(state.rescue_active), \
        jnp.zeros_like(state.rescue_phase)


@dataclasses.dataclass
class SyncSimulator:
    """Batched synchronous replanning loop for one mission.

    Orchestration analog of MultiSyncSimulator::run (:83-147) with the
    planner pipeline of TrajPlanner::planImpl (traj_planner.cpp:344-373)
    inlined as one fused device program.
    """
    mission: Mission
    param: Param
    esdf: object = None           # world.esdf.ESDF | None (octomap worlds)
    dtype: object = jnp.float32

    def __post_init__(self):
        self.param = self.param.validated()
        p = self.param
        self.N = self.mission.qn
        self.M, self.n = p.M, p.n
        self.optimizer = TrajOptimizer(p)
        arrs = self.mission.agent_arrays()
        dt = self.dtype
        self.start = jnp.asarray(arrs["start"], dt)
        self.desired_goal = jnp.asarray(arrs["goal"], dt)
        self.radius = jnp.asarray(arrs["radius"], dt)
        self.downwash = jnp.asarray(arrs["downwash"], dt)
        self.nominal_velocity = jnp.asarray(arrs["nominal_velocity"], dt)
        self.max_vel = jnp.asarray(arrs["max_vel"], dt)
        self.max_acc = jnp.asarray(arrs["max_acc"], dt)
        self.world_min = jnp.asarray(self.mission.world_min, dt)
        self.world_max = jnp.asarray(self.mission.world_max, dt)
        # K-NN pruning interaction-ball radius: pairs farther apart than
        # this cannot interact within one horizon (feasible trajectories
        # stay within vmax*T of their starts), so only neighbours inside
        # it ever need LSC rows; the K-th-nearest-inside-ball audit in
        # plan_block flags density overflow.
        self._knn_cutoff = float(
            2.0 * np.max(arrs["max_vel"]) * p.M * p.dt +
            2.0 * np.max(arrs["radius"]))
        # The reference merges them into the planner's occupancy grid
        # (grid_based_planner.cpp:125-160) and computes box closest
        # points for constraints (obstacle.hpp:437-478); its LSC mode
        # explicitly says "use octomap" for them
        # (traj_planner.cpp:1375-1377).  Here they are folded into the
        # ESDF (analytic, sub-voxel box distance), so the SFC corridor,
        # wavefront grid planner, LOS checks, compatibility gate, and a
        # dedicated exact box audit all see them; they are EXCLUDED from
        # the dynamic-obstacle LSC path (no sphere approximation).
        static_specs = [o for o in self.mission.obstacles
                        if o.kind == "static"]
        dyn_specs = [o for o in self.mission.obstacles
                     if o.kind != "static"]
        if static_specs:
            boxes = np.stack([
                np.concatenate([np.asarray(o.pose, float) -
                                np.asarray(o.dimensions, float),
                                np.asarray(o.pose, float) +
                                np.asarray(o.dimensions, float)])
                for o in static_specs])
            self.static_boxes = jnp.asarray(boxes, dt)
            if self.esdf is not None:
                self.esdf = self.esdf.merge_boxes(boxes)
            else:
                from ..world.esdf import ESDF
                self.esdf = ESDF.from_boxes(
                    boxes, self.mission.world_min, self.mission.world_max,
                    resolution=p.world_resolution, dtype=dt)
        else:
            self.static_boxes = jnp.zeros((0, 6), dt)

        self.corridor = None
        if self.esdf is not None:
            # mission/world compatibility gate: a start or goal inside the
            # static world makes the SFC seed infeasible (the reference
            # throws from expandBoxFromPoint, corridor_constructor.hpp:35-38;
            # without this gate the run silently degrades into collisions)
            s_clear = np.asarray(self.esdf.at_points(self.start))
            g_clear = np.asarray(self.esdf.at_points(self.desired_goal))
            r = np.asarray(self.radius)
            bad = [(qi, float(s_clear[qi]), float(g_clear[qi]))
                   for qi in range(self.N)
                   if s_clear[qi] < r[qi] or g_clear[qi] < r[qi]]
            if bad:
                raise ValueError(
                    "mission incompatible with world: start/goal inside or "
                    f"too close to static obstacles for agents {bad} "
                    "(agent, start clearance, goal clearance)")
            from ..world.corridor import CorridorBuilder
            self.corridor = CorridorBuilder(
                self.esdf, self.mission.world_min, self.mission.world_max,
                agent_radius=float(self.mission.agents[0].radius),
                dtype=self.dtype)

        # dynamic obstacles (obstacle_generator.hpp analog); static boxes
        # were moved into the world geometry above
        self.obstacle_generator = None
        self.O_dyn = len(dyn_specs)
        if self.O_dyn:
            import dataclasses as _dc
            from .obstacles import ObstacleGenerator
            self.obstacle_generator = ObstacleGenerator(
                _dc.replace(self.mission, obstacles=dyn_specs),
                noise_std=p.obs_observer_stddev)
            self.obs_radius_dyn = jnp.asarray(
                self.obstacle_generator.radii, dt)
            self.obs_downwash_dyn = jnp.asarray(
                self.obstacle_generator.downwash, dt)
            self.obs_max_acc_dyn = jnp.asarray(
                self.obstacle_generator.max_acc, dt)
        else:
            self.obs_radius_dyn = jnp.zeros((0,), dt)
            self.obs_downwash_dyn = jnp.ones((0,), dt)
            self.obs_max_acc_dyn = jnp.zeros((0,), dt)

        self._cycle_jit = jax.jit(exact_f32(self._cycle))
        self.goal_planner = goal_mod.GoalPlanner(self.mission, p, self.esdf,
                                                 dtype=self.dtype)

    # ------------------------------------------------------------------
    def initial_state(self) -> SwarmState:
        N, M, n = self.N, self.M, self.n
        dt = self.dtype
        traj = jnp.broadcast_to(self.start[:, None, None, :],
                                (N, M, n + 1, 3)).astype(dt)
        zeros = jnp.zeros((N, 3), dt)
        return SwarmState(
            traj=traj, pos=self.start, vel=zeros, acc=zeros,
            current_goal=self.desired_goal,
            seq=jnp.zeros((), jnp.int32),
            qp_cost=jnp.zeros((N,), dt),
            primal_res=jnp.zeros((N,), dt),
            safety_agent_min=jnp.asarray(np.inf, dt),
            distance=jnp.zeros((), dt),
            sfc=jnp.zeros((N, M, 6), dt),
            sfc_initialized=jnp.zeros((N,), bool),
            start=self.start,
            desired_goal=self.desired_goal,
            safety_obs_min=jnp.asarray(np.inf, dt),
            stall_count=jnp.zeros((N,), jnp.int32),
            rescue_goal=zeros,
            rescue_active=jnp.zeros((N,), bool),
            rescue_phase=jnp.zeros((N,), jnp.int32),
            slack_flags=jnp.zeros((N,), bool),
            path_floor=self.start,
            best_goal_dist=jnp.full((N,), np.inf, dt),
        )

    # ------------------------------------------------------------------
    def propagate(self, state: SwarmState):
        """Ideal flat-output rollout of the previous solutions by one time
        step (update(), multi_sync_simulator.cpp:190-246).

        With time_step == dt (the LSC requirement) the rollout lands
        exactly on the segment-1 boundary, whose position/velocity/
        acceleration are closed-form differences of the first control
        points of segment 1 -- three gathers instead of a full polynomial
        evaluation."""
        p = self.param
        is_first = state.seq == 0
        n = self.n
        if abs(p.multisim_time_step - p.dt) < 1e-9 and self.M > 1:
            seg = state.traj[:, 1]                   # (N, n+1, 3)
            rpos = seg[:, 0]
            rvel = (seg[:, 1] - seg[:, 0]) * (n / p.dt)
            racc = (seg[:, 2] - 2 * seg[:, 1] + seg[:, 0]) * \
                (n * (n - 1) / p.dt ** 2)
        else:
            rolled = jax.vmap(lambda tr: bz.traj_state(
                tr, p.multisim_time_step, p.dt))(state.traj)
            rpos, rvel, racc = rolled["pos"], rolled["vel"], rolled["acc"]
        pos = jnp.where(is_first, state.pos, rpos)
        vel = jnp.where(is_first, state.vel, rvel)
        acc = jnp.where(is_first, state.acc, racc)
        return pos, vel, acc

    def orca_velocities(self, pos, vel, current_goal):
        """All-agent ORCA velocities with reference parameterization
        (updateORCAVelocity, traj_planner.cpp:1063-1223): radius inflated
        by orca_inflation_ratio, preferred velocity toward the current goal
        capped by max_vel * pref_velocity_ratio (including the reference's
        squared-norm-vs-speed comparison, replicated for parity)."""
        from ..ops import orca as orca_ops
        p = self.param
        pref_speed = self.max_vel[:, 0] * p.orca_pref_velocity_ratio
        gvec = current_goal - pos
        too_fast = jnp.sum(gvec * gvec, axis=-1) > pref_speed
        gnorm = jnp.linalg.norm(gvec, axis=-1, keepdims=True)
        gvec = jnp.where(too_fast[:, None],
                         gvec / jnp.maximum(gnorm, 1e-9) *
                         pref_speed[:, None], gvec)
        return orca_ops.orca_velocities(
            pos, vel, self.radius * p.orca_inflation_ratio,
            pref_vel=gvec, max_speed=pref_speed,
            is_dynamic=jnp.zeros((self.N,), bool),
            time_horizon=p.orca_horizon, time_step=0.5,
            force_z_zero=(p.world_dimension == 2))

    def _traj_for_mode(self, mode, traj, pos, vel, seq, prev_goal=None):
        """Trajectory builder shared by the prediction and initial-traj
        stages (traj_planner.cpp:610-1061)."""
        from ..config import PredictionMode, InitialTrajMode
        p = self.param
        if mode == InitialTrajMode.GREEDY:
            # straight toward the (previous cycle's) current goal at the
            # nominal velocity, clamped at the ideal flight time
            # (initialTrajPlanningGreedy, traj_planner.cpp:983-995)
            goal = prev_goal if prev_goal is not None else pos
            delta = goal - pos
            dist = jnp.linalg.norm(delta, axis=-1, keepdims=True)
            dirn = delta / jnp.maximum(dist, 1e-9)
            t_ideal = dist / jnp.maximum(
                self.nominal_velocity[:, None], 1e-9)
            m = jnp.arange(self.M, dtype=pos.dtype)[:, None]
            i = jnp.arange(self.n + 1, dtype=pos.dtype)[None, :]
            tau = (m + i / self.n) * p.dt                    # (M, n+1)
            t_clamped = jnp.minimum(tau[None, :, :, None],
                                    t_ideal[:, None, None, :])
            return pos[:, None, None, :] + dirn[:, None, None, :] * \
                self.nominal_velocity[:, None, None, None] * t_clamped
        if mode == InitialTrajMode.SKIP:
            # debugger-only mode in the reference (keep the stored initial
            # trajectory); maps to the previous-solution shift here
            mode = InitialTrajMode.PREVIOUS_SOLUTION
        if mode in (PredictionMode.PREVIOUS_SOLUTION,
                    InitialTrajMode.PREVIOUS_SOLUTION):
            shifted = pred.shift_previous_solution(traj)
            const_vel = pred.constant_velocity_traj(pos, vel, self.M,
                                                    self.n, p.dt)
            use_shift = (seq >= 1)[..., None, None, None]
            return jnp.where(use_shift, shifted, const_vel)
        if mode in (PredictionMode.VELOCITY, InitialTrajMode.VELOCITY,
                    PredictionMode.ORACLE,
                    PredictionMode.LINEAR_KALMAN_FILTER):
            # oracle / KF refine *dynamic-obstacle* predictions (handled on
            # the host in run()); agent obstacles use constant velocity
            # exactly like the reference's agent branches
            # (traj_planner.cpp:741-749)
            return pred.constant_velocity_traj(pos, vel, self.M, self.n,
                                               p.dt)
        if mode in (PredictionMode.POSITION, InitialTrajMode.POSITION):
            return pred.constant_position_traj(pos, self.M, self.n)
        raise NotImplementedError(mode)

    def predict_and_init(self, traj, pos, vel, seq, prev_goal=None):
        """Obstacle prediction + initial trajectory.  In LSC mode both are
        the previous-solution shift, so one tensor serves as this agent's
        initial trajectory and every other agent's prediction of it."""
        p = self.param
        prediction = self._traj_for_mode(p.prediction_mode, traj, pos,
                                         vel, seq)
        if p.initial_traj_mode.value == p.prediction_mode.value:
            init = prediction
        else:
            init = self._traj_for_mode(p.initial_traj_mode, traj, pos,
                                       vel, seq, prev_goal=prev_goal)
        return init, prediction

    def plan_block(self, pos, vel, acc, init, seq,
                   pred_global, obs_pos_global, obs_goal_global,
                   obs_prev_global, self_mask,
                   radius, downwash, nominal_velocity, max_vel, max_acc,
                   desired_goal, sfc_prev=None, sfc_initialize=None,
                   sfc_seed=None, y_warm=None, dyn_pos=None, dyn_vel=None,
                   dyn_pred=None, rescue_goal=None, rescue_active=None,
                   obs_radius_global=None, obs_downwash_global=None,
                   obs_maxacc_global=None, obs_slack_global=None,
                   self_slack=None):
        """Plan one block of agents (L, ...) against the global obstacle
        view (N_total, ...).  Returns (QPResult, current_goal, sfc,
        knn_overflow, path_floor) -- knn_overflow is the per-agent
        density-overflow audit of the K-NN pruning (None when pruning is
        off); path_floor the grid-path rescue candidate (see SwarmState).

        obs_*_global override the default all-agent attribute arrays when
        the obstacle view is not the identity-ordered full swarm (e.g.
        the ring-halo view in parallel/shard.py)."""
        p = self.param
        L = pos.shape[0]
        O = pred_global.shape[0]
        M, n = self.M, self.n
        obs_radius_all = (self.radius if obs_radius_global is None
                          else obs_radius_global)
        obs_downwash_all = (self.downwash if obs_downwash_global is None
                            else obs_downwash_global)
        obs_maxacc_all = (self.max_acc[:, 0] if obs_maxacc_global is None
                          else obs_maxacc_global)

        current_goal, path_floor = self.goal_planner.plan(
            pos=pos, vel=vel, init_traj=init, desired_goal=desired_goal,
            seq=seq, radius=radius, downwash=downwash,
            obs_pos=obs_pos_global, obs_goal=obs_goal_global,
            obs_prev_traj=obs_prev_global, self_mask=self_mask,
            obs_radius=obs_radius_all, obs_downwash=obs_downwash_all)
        if rescue_goal is not None and rescue_active is not None:
            # latched deadlock-escape waypoint replaces the subgoal while
            # active (see _update_rescue)
            current_goal = jnp.where(rescue_active[:, None], rescue_goal,
                                     current_goal)

        K = p.max_neighbors
        knn_overflow = None
        if 0 < K < O:
            # spatial K-NN pruning of LSC pairs (SURVEY.md 5.7: the CP/ring
            # analog).  SOUNDNESS: any feasible trajectory stays within
            # vmax * horizon of its start (derivative rows), so a pair
            # farther apart than R = 2 vmax T + r_i + r_j cannot
            # interact this cycle and its half-spaces are redundant;
            # pairs INSIDE that ball but beyond the K nearest would not
            # be, so the runtime audit below flags any agent whose K-th
            # nearest neighbour is still inside the ball (K too small
            # for the local density -> pruning soundness not guaranteed
            # that cycle).  Neighbours beyond the ball are additionally
            # masked out, which trims constraint clutter at no cost.
            d2 = jnp.sum((obs_pos_global[None, :, :] - pos[:, None, :])**2,
                         axis=-1)
            d2 = jnp.where(self_mask, jnp.inf, d2)
            negd2, nbr = jax.lax.top_k(-d2, K)                 # (L, K)
            sel_d2 = -negd2                    # ascending distances^2
            R_int = self._knn_cutoff
            knn_overflow = sel_d2[:, -1] < R_int * R_int
            # one-hot (L*K, O) x (O, M(n+1)3) selection matmul instead of
            # a data-dependent gather of (L, K) trajectory rows: chosen on
            # the previous chip, where gathers were slow; its A/B against
            # the gather on the H100 is ROADMAP 1.4.  It must be exact
            # (full f32, see exact_f32): the rows are world coordinates.
            # Above ~512 MB of selection matrix the materialized one-hot
            # stops paying for itself; fall back to the gather there.
            if L * K * O * 4 <= 512 * 2 ** 20:
                onehot = jax.nn.one_hot(nbr, O, dtype=pred_global.dtype)
                obs_pred = jnp.einsum(
                    "lko,of->lkf", onehot, pred_global.reshape(O, -1),
                ).reshape((L, K) + pred_global.shape[1:])      # (L,K,M,n+1,3)
                # the per-neighbour scalar attributes ride the same
                # selection matmul
                attrs = jnp.stack([obs_radius_all, obs_downwash_all,
                                   obs_maxacc_all], axis=-1)   # (O, 3)
                sel = jnp.einsum("lko,oa->lka", onehot,
                                 attrs.astype(pred_global.dtype))
                obs_radius = sel[..., 0]
                obs_downwash = sel[..., 1]
                obs_max_acc = sel[..., 2]
            else:
                obs_pred = pred_global[nbr]
                obs_radius = obs_radius_all[nbr]
                obs_downwash = obs_downwash_all[nbr]
                obs_max_acc = obs_maxacc_all[nbr]
            obs_is_agent = jnp.ones((L, K), bool)
            obs_mask = sel_d2 <= R_int * R_int
            obs_slack = (obs_slack_global[nbr]
                         if obs_slack_global is not None else None)
        else:
            obs_pred = jnp.broadcast_to(pred_global[None],
                                        (L, O, M, n + 1, 3))
            obs_is_agent = jnp.ones((L, O), bool)
            obs_mask = ~self_mask
            obs_radius = jnp.broadcast_to(obs_radius_all[None, :], (L, O))
            obs_downwash = jnp.broadcast_to(obs_downwash_all[None, :],
                                            (L, O))
            obs_max_acc = jnp.broadcast_to(obs_maxacc_all[None, :], (L, O))
            obs_slack = (jnp.broadcast_to(obs_slack_global[None, :], (L, O))
                         if obs_slack_global is not None else None)

        # --- append mission dynamic obstacles (constant-velocity
        #     prediction for non-agents, traj_planner.cpp:838-847;
        #     oracle mode passes the exact fitted prediction) ---
        if self.O_dyn and dyn_pos is not None:
            Od = self.O_dyn
            if dyn_pred is None:
                dyn_pred = pred.constant_velocity_traj(dyn_pos, dyn_vel,
                                                       M, n, p.dt)
            # dyn_pred may be shared (Od, M, n+1, 3) or already per-agent
            # (L, Od, M, n+1, 3) -- the independent-observation KF path
            dyn_pred_b = (jnp.broadcast_to(dyn_pred[None],
                                           (L, Od, M, n + 1, 3))
                          if dyn_pred.ndim == 4 else dyn_pred)
            obs_pred = jnp.concatenate([obs_pred, dyn_pred_b], axis=1)
            obs_is_agent = jnp.concatenate(
                [obs_is_agent, jnp.zeros((L, Od), bool)], axis=1)
            obs_mask = jnp.concatenate(
                [obs_mask, jnp.ones((L, Od), bool)], axis=1)
            obs_radius = jnp.concatenate(
                [obs_radius, jnp.broadcast_to(self.obs_radius_dyn[None],
                                              (L, Od))], axis=1)
            obs_downwash = jnp.concatenate(
                [obs_downwash,
                 jnp.broadcast_to(self.obs_downwash_dyn[None], (L, Od))],
                axis=1)
            obs_max_acc = jnp.concatenate(
                [obs_max_acc,
                 jnp.broadcast_to(self.obs_max_acc_dyn[None], (L, Od))],
                axis=1)
            if obs_slack is not None:
                # host-built dynamic predictions start at the observed
                # positions, so obstaclePredictionCheck never fires for
                # them (traj_planner.cpp:866-878 deviation is zero)
                obs_slack = jnp.concatenate(
                    [obs_slack, jnp.zeros((L, Od), bool)], axis=1)

        from ..config import PredictionMode
        if p.prediction_mode in (PredictionMode.VELOCITY,
                                 PredictionMode.ORCA):
            # linear-prediction slowdown (generateLSC preamble,
            # traj_planner.cpp:1310-1330): contract colliding straight-line
            # predictions so the LSC margins stay feasible
            alpha = pred.linear_prediction_slowdown(
                init, obs_pred, radius, obs_radius, obs_mask,
                horizon=M * p.dt,
                esdf=self.goal_planner.esdf if p.world_use_octomap
                else None)
            init = pred.contract_trajectories(init, alpha)
            obs_pred = pred.contract_trajectories(obs_pred, alpha[:, None])

        slack_spec = None
        if p.planner_mode == PlannerMode.LSC:
            slack_flags = sizes = None
            if obs_slack is not None and self_slack is not None:
                # disturbance path (traj_planner.cpp:1388-1400 +
                # traj_optimizer.cpp:317-326): a deviated agent slacks
                # ALL its obstacle rows; everyone slacks the deviated
                # obstacle's rows; non-agent slack obstacles switch to
                # the RSFC margin
                slack_flags = (obs_slack | self_slack[:, None]) & obs_mask
                sizes = pred.obstacle_size_prediction(
                    obs_radius, obs_max_acc, M, n, p.dt,
                    p.obs_uncertainty_horizon, p.obs_size_prediction)
                from ..planner.optimizer import SlackSpec
                slack_spec = SlackSpec(
                    mode="collision", enable=slack_flags,
                    n_slack_c=obs_pred.shape[1],
                    weight=p.slack_collision_weight)
            planes = cons.lsc_planes(init, obs_pred, radius, downwash,
                                     obs_radius, obs_downwash,
                                     obs_is_agent, obs_mask,
                                     slack_flags=slack_flags,
                                     obs_pred_sizes=sizes,
                                     guard_margin=p.lsc_guard_margin)
        elif p.planner_mode == PlannerMode.BVC:
            planes = cons.bvc_planes(init, obs_pred, radius, downwash,
                                     obs_radius, obs_downwash,
                                     obs_is_agent, obs_mask)
        elif p.planner_mode == PlannerMode.RECIPROCAL_RSFC:
            from ..planner.optimizer import SlackSpec
            C_obs = obs_pred.shape[1]
            obs_sizes = pred.obstacle_size_prediction(
                obs_radius, obs_max_acc, M, n, p.dt,
                p.obs_uncertainty_horizon, p.obs_size_prediction)
            planes = cons.rsfc_planes(init, obs_pred, obs_sizes, radius,
                                      downwash, obs_radius, obs_downwash,
                                      obs_is_agent, obs_mask)
            slack_spec = SlackSpec(
                mode="collision",
                enable=obs_mask, n_slack_c=C_obs,
                weight=p.slack_collision_weight)
        else:
            raise NotImplementedError(p.planner_mode)

        # SFC corridors against the static world
        # (generateFeasibleSFC, traj_planner.cpp:1451-1491)
        sfc = sfc_prev
        if self.corridor is not None:
            from ..world.corridor import update_sfc
            sfc, _ = update_sfc(sfc_prev, sfc_seed, current_goal,
                                self.corridor, sfc_initialize)
            sfc_pl = cons.sfc_planes(sfc, active=True, init_traj=init,
                                     guard_margin=p.lsc_guard_margin)
            planes = cons.concat_planes(planes, sfc_pl, n_ctrl=n + 1)
        else:
            planes = cons.concat_planes(planes, n_ctrl=n + 1)

        if y_warm is None:
            # warm start from the (feasible) shifted previous solution
            y_warm = self.optimizer.extract_y(init).astype(self.dtype)
        res = self.optimizer.solve(
            pos, vel, acc, current_goal,
            nominal_velocity=nominal_velocity,
            max_vel=max_vel, max_acc=max_acc,
            planes=planes, world_min=self.world_min,
            world_max=self.world_max, y_warm=y_warm, slack=slack_spec,
            dtype=self.dtype)
        return res, current_goal, sfc, knn_overflow, path_floor

    def _patrol_swap(self, state: SwarmState, pos):
        """PATROL: swap start and desired goal when an agent reaches its
        goal (goalPlanning, traj_planner.cpp:479-485)."""
        p = self.param
        if not p.multisim_patrol:
            return state.start, state.desired_goal
        near = jnp.linalg.norm(pos - state.desired_goal, axis=-1) \
            < p.goal_threshold
        new_goal = jnp.where(near[:, None], state.start,
                             state.desired_goal)
        new_start = jnp.where(near[:, None], state.desired_goal,
                              state.start)
        return new_start, new_goal

    # ------------------------------------------------------------------
    def _cycle(self, state: SwarmState, dyn_pos=None, dyn_vel=None,
               dyn_pred=None) -> tuple:
        """One synchronous planning cycle for all agents (single device)."""
        p = self.param
        N = self.N
        dt = self.dtype
        if dyn_pos is None:
            dyn_pos = jnp.zeros((self.O_dyn, 3), dt)
            dyn_vel = jnp.zeros((self.O_dyn, 3), dt)

        pos, vel, acc = self.propagate(state)
        start, desired_goal = self._patrol_swap(state, pos)

        # stall bookkeeping for deadlock rescue (deadlock_start_seq
        # analog, traj_planner.cpp:396-409).  Watermark hysteresis: the
        # count resets only on beating the agent's best-ever goal
        # distance -- a velocity blip or a push-back recovery must not
        # cancel the escalation (see _update_stall_count).
        goal_changed = jnp.any(desired_goal != state.desired_goal, axis=-1)
        best_prev = jnp.where(goal_changed, jnp.inf, state.best_goal_dist)
        stall_count, progress, progress_best, best_goal_dist = \
            _update_stall_count(state.stall_count, best_prev, state.pos,
                                pos, vel, desired_goal, state.seq, p,
                                has_static=self.esdf is not None)
        if p.deadlock_rescue:
            rescue_goal, rescue_active, rescue_phase, stall_count = \
                _update_rescue(state, pos, desired_goal, stall_count,
                               progress, p, esdf=self.esdf,
                               radius=self.radius,
                               world_min=self.world_min,
                               world_max=self.world_max,
                               progress_best=progress_best)
        else:
            rescue_goal, rescue_active, rescue_phase = _no_rescue(state)

        if p.planner_mode == PlannerMode.ORCA:
            return self._cycle_orca(state, pos, vel, acc, start,
                                    desired_goal, dyn_pos)

        init, prediction = self.predict_and_init(state.traj, pos, vel,
                                                 state.seq,
                                                 prev_goal=state.current_goal)

        # SFC seed: the previous solution endpoint, or the current position
        # on (re-)initialization (traj_planner.cpp:1454-1473)
        sfc_initialize = ~state.sfc_initialized

        # --- disturbance-reset slack path (experiment mode only; the
        #     checks are dead weight in pure simulation where no external
        #     poses are ever injected) ---
        obs_slack_global = self_slack = None
        if p.multisim_experiment and state.slack_flags is not None:
            # own-deviation gate (initialTrajPlanningCheck,
            # traj_planner.cpp:1047-1061): collapse the initial traj to
            # the current position, re-seed the SFC, slack ALL obstacles
            init, self_reset = pred.initial_traj_check(
                init, pos, p.multisim_reset_threshold)
            sfc_initialize = sfc_initialize | self_reset
            self_slack = state.slack_flags | self_reset
            # other-agent deviations (obstaclePredictionCheck analog,
            # :866-878): inject_positions froze their trajectories, so
            # the flags carry which obstacles need slack rows
            obs_slack_global = state.slack_flags
        sfc_seed = jnp.where(sfc_initialize[:, None], pos,
                             state.traj[:, -1, -1, :])
        res, current_goal, sfc, knn_overflow, path_floor = self.plan_block(
            pos, vel, acc, init, state.seq,
            pred_global=prediction, obs_pos_global=pos,
            obs_goal_global=desired_goal,
            obs_prev_global=state.traj,
            self_mask=jnp.eye(N, dtype=bool),
            radius=self.radius, downwash=self.downwash,
            nominal_velocity=self.nominal_velocity,
            max_vel=self.max_vel, max_acc=self.max_acc,
            desired_goal=desired_goal,
            sfc_prev=state.sfc, sfc_initialize=sfc_initialize,
            sfc_seed=sfc_seed, dyn_pos=dyn_pos, dyn_vel=dyn_vel,
            dyn_pred=dyn_pred,
            rescue_goal=rescue_goal, rescue_active=rescue_active,
            obs_slack_global=obs_slack_global, self_slack=self_slack)

        # QPFAILED report + feasible fallback (traj_optimizer.cpp:99-144
        # analog): an agent whose QP output violates constraints beyond
        # the threshold keeps its shifted previous solution -- feasible
        # for EVERY LSC plane by construction -- instead of flying the
        # violating trajectory.  One bad solve can then never poison the
        # swarm through next cycle's predictions.
        qp_failed = res.primal_res > p.qp_failure_threshold
        res = res._replace(traj=jnp.where(qp_failed[:, None, None, None],
                                          init, res.traj))

        # safety audit + metrics over the upcoming time step
        # (savePlanningResult, multi_sync_simulator.cpp:446-503)
        safety_step = audit.step_safety_ratio(
            res.traj, self.radius, self.downwash, p.dt,
            p.multisim_record_time_step, p.multisim_time_step)
        step_dist = audit.step_distance(
            res.traj, p.dt, p.multisim_record_time_step,
            p.multisim_time_step)
        if self.O_dyn:
            obs_safety = audit.obstacle_safety_ratio(
                pos, dyn_pos, self.radius, self.obs_radius_dyn)
        else:
            obs_safety = jnp.asarray(np.inf, dt)
        if self.static_boxes.shape[0]:
            obs_safety = jnp.minimum(obs_safety,
                                     audit.static_box_safety_ratio(
                                         pos, self.static_boxes,
                                         self.radius))

        new_state = SwarmState(
            traj=res.traj, pos=pos, vel=vel, acc=acc,
            current_goal=current_goal,
            seq=state.seq + 1,
            qp_cost=res.cost, primal_res=res.primal_res,
            safety_agent_min=jnp.minimum(state.safety_agent_min,
                                         safety_step),
            distance=state.distance + step_dist,
            sfc=sfc if sfc is not None else state.sfc,
            sfc_initialized=jnp.ones_like(state.sfc_initialized),
            start=start, desired_goal=desired_goal,
            safety_obs_min=jnp.minimum(state.safety_obs_min, obs_safety),
            stall_count=stall_count,
            rescue_goal=rescue_goal, rescue_active=rescue_active,
            rescue_phase=rescue_phase,
            slack_flags=(jnp.zeros_like(state.slack_flags)
                         if state.slack_flags is not None else None),
            path_floor=path_floor,
            best_goal_dist=best_goal_dist,
        )
        info = CycleInfo(safety_step_min=safety_step, qp_cost=res.cost,
                         primal_res=res.primal_res,
                         warm_res=(res.warm_res if res.warm_res is not None
                                   else jnp.zeros_like(res.cost)),
                         warm_row=(res.warm_row if res.warm_row is not None
                                   else jnp.zeros_like(res.cost,
                                                       dtype=jnp.int32)),
                         qp_failed=qp_failed,
                         knn_overflow=knn_overflow,
                         qp_iters=res.iters)
        return new_state, info

    def _cycle_orca(self, state: SwarmState, pos, vel, acc, start,
                    desired_goal, dyn_pos):
        """ORCA planner mode (planORCA, traj_planner.cpp:375-387): the new
        trajectory is a straight line at the ORCA velocity; no QP."""
        p = self.param
        if p.goal_mode == GoalMode.ORCA:
            orca_v = self.orca_velocities(pos, vel, state.current_goal)
            current_goal, path_floor = self.goal_planner.plan(
                pos=pos, vel=vel, init_traj=state.traj,
                desired_goal=desired_goal, seq=state.seq,
                radius=self.radius, downwash=self.downwash,
                orca_vel=orca_v)
        else:
            current_goal, path_floor = self.goal_planner.plan(
                pos=pos, vel=vel, init_traj=state.traj,
                desired_goal=desired_goal, seq=state.seq,
                radius=self.radius, downwash=self.downwash,
                prev_traj=state.traj)
            orca_v = self.orca_velocities(pos, vel, current_goal)

        traj = pred.constant_velocity_traj(pos, orca_v, self.M, self.n,
                                           p.dt)
        safety_step = audit.step_safety_ratio(
            traj, self.radius, self.downwash, p.dt,
            p.multisim_record_time_step, p.multisim_time_step)
        step_dist = audit.step_distance(
            traj, p.dt, p.multisim_record_time_step, p.multisim_time_step)
        zeros = jnp.zeros((self.N,), self.dtype)
        new_state = SwarmState(
            traj=traj, pos=pos, vel=vel, acc=acc,
            current_goal=current_goal, seq=state.seq + 1,
            qp_cost=zeros, primal_res=zeros,
            safety_agent_min=jnp.minimum(state.safety_agent_min,
                                         safety_step),
            distance=state.distance + step_dist,
            sfc=state.sfc,
            sfc_initialized=state.sfc_initialized,
            start=start, desired_goal=desired_goal,
            safety_obs_min=state.safety_obs_min,
            stall_count=state.stall_count,
            rescue_goal=state.rescue_goal,
            rescue_active=state.rescue_active,
            rescue_phase=state.rescue_phase,
            slack_flags=state.slack_flags,
            path_floor=path_floor,
            best_goal_dist=state.best_goal_dist)
        info = CycleInfo(safety_step_min=safety_step, qp_cost=zeros,
                         primal_res=zeros)
        return new_state, info

    def make_scan_cycle(self, k: int):
        """Fuse `k` planning cycles into ONE device dispatch via lax.scan.

        The reference replans at 5 Hz with a hard host round trip per
        cycle (ROS spin); here every dispatch pays host launch overhead,
        which can exceed the device compute of a small swarm.  Scanning k
        cycles on device amortizes it to ~1/k and lets XLA pipeline
        across cycle boundaries.  Only valid when nothing needs
        the host mid-cycle: no analytic dynamic obstacles (they are
        evaluated host-side per cycle) and no real-time pacing.

        Returns multi(state) -> (state_k, (CycleInfo stacked (k, ...),
        max_goal_dist (k,), cum_distance (k,))); the stacked per-cycle
        goal distances and cumulative flight distance let the host
        recover the exact finishing cycle and its metrics inside a block
        after the fact.
        """
        if self.obstacle_generator is not None:
            raise ValueError("scan-fused cycles need device-only state; "
                             "dynamic obstacles are evaluated on the host "
                             "per cycle (use steps_per_dispatch=1)")

        def body(state, _):
            new_state, info = self._cycle(state)
            goal_dist = jnp.max(jnp.linalg.norm(
                new_state.pos - new_state.desired_goal, axis=-1))
            return new_state, (info, goal_dist, new_state.distance)

        return jax.jit(exact_f32(
            lambda state: jax.lax.scan(body, state, None, length=k)))

    def _oracle_prediction(self, t_sim: float) -> np.ndarray:
        """Perfect dynamic-obstacle prediction: sample the true analytic
        model over the horizon and fit Bernstein control points per segment
        (obstaclePredictionWithOracle, traj_planner.cpp:715-751).
        Returns (O_dyn, M, n+1, 3)."""
        from .obstacles import ChasingObstacle
        p = self.param
        M, n = self.M, self.n
        basis = np.zeros((n + 1, n + 1))
        for r, t in enumerate(np.linspace(0.0, 1.0, n + 1)):
            for i in range(n + 1):
                basis[r, i] = bz.nchoosek(n, i) * t ** i * \
                    (1 - t) ** (n - i)
        basis_inv = np.linalg.inv(basis)
        out = np.zeros((self.O_dyn, M, n + 1, 3))
        for oi, model in enumerate(self.obstacle_generator.models):
            if isinstance(model, ChasingObstacle):
                raise ValueError("oracle does not support chasing "
                                 "obstacles (traj_planner.cpp:719-721)")
            for m in range(M):
                targets = np.stack([
                    model.state(t_sim + (m + i / n) * p.dt)[0]
                    for i in range(n + 1)])
                out[oi, m] = basis_inv @ targets
        return out

    # ------------------------------------------------------------------
    @exact_f32
    def profile_stages(self, state: SwarmState, n_cycles: int = 5) -> dict:
        """Per-stage device timing with the reference's stage taxonomy
        (PlanningTimeStatistics, include/sp_const.hpp:89-128; inline stage
        timers traj_planner.cpp:349-364).  Each stage is jitted separately
        and timed with block_until_ready; the fused production cycle has no
        stage boundaries, so these are diagnostic numbers."""
        p = self.param
        N = self.N

        stage_pred = jax.jit(lambda st: self.predict_and_init(
            st.traj, *self.propagate(st)[:2], st.seq))
        stage_goal = jax.jit(lambda pos, vel, init, st:
                             self.goal_planner.plan(
                                 pos=pos, vel=vel, init_traj=init,
                                 desired_goal=st.desired_goal, seq=st.seq,
                                 radius=self.radius,
                                 downwash=self.downwash,
                                 prev_traj=st.traj))

        K = p.max_neighbors

        def lsc_stage(init, prediction, pos):
            if 0 < K < N:
                d2 = jnp.sum((pos[None] - pos[:, None]) ** 2, axis=-1)
                d2 = jnp.where(jnp.eye(N, dtype=bool), jnp.inf, d2)
                _, nbr = jax.lax.top_k(-d2, K)
                return cons.lsc_planes(
                    init, prediction[nbr], self.radius, self.downwash,
                    self.radius[nbr], self.downwash[nbr],
                    jnp.ones((N, K), bool), jnp.ones((N, K), bool),
                    guard_margin=p.lsc_guard_margin)
            obs_pred = jnp.broadcast_to(prediction[None],
                                        (N, N, self.M, self.n + 1, 3))
            return cons.lsc_planes(
                init, obs_pred, self.radius, self.downwash,
                jnp.broadcast_to(self.radius[None], (N, N)),
                jnp.broadcast_to(self.downwash[None], (N, N)),
                jnp.ones((N, N), bool), ~jnp.eye(N, dtype=bool),
                guard_margin=p.lsc_guard_margin)
        stage_lsc = jax.jit(lsc_stage)

        times = {}

        def timeit(name, fn, *args):
            fn(*args)  # compile
            outs = None
            t0 = time.perf_counter()
            for _ in range(n_cycles):
                outs = fn(*args)
                jax.tree.map(
                    lambda x: x.block_until_ready()
                    if hasattr(x, "block_until_ready") else x, outs)
            times[name] = (time.perf_counter() - t0) / n_cycles
            return outs

        init, prediction = timeit("obstacle_prediction", stage_pred, state)
        times["initial_traj"] = 0.0   # shared with prediction in LSC mode
        pos, vel, acc = self.propagate(state)
        timeit("goal_planning", stage_goal, pos, vel, init, state)
        planes = timeit("lsc_generation", stage_lsc, init, prediction, pos)
        if self.corridor is not None:
            from ..world.corridor import update_sfc
            stage_sfc = jax.jit(lambda sfc, seed, goal, flag: update_sfc(
                sfc, seed, goal, self.corridor, flag))
            timeit("sfc_generation", stage_sfc, state.sfc, pos,
                   state.desired_goal, ~state.sfc_initialized)
        else:
            times["sfc_generation"] = 0.0
        planes_c = cons.concat_planes(planes, n_ctrl=self.n + 1)
        stage_qp = jax.jit(lambda pos, vel, acc, goal, pl, yw:
                           self.optimizer.solve(
                               pos, vel, acc, goal,
                               nominal_velocity=self.nominal_velocity,
                               max_vel=self.max_vel, max_acc=self.max_acc,
                               planes=pl, world_min=self.world_min,
                               world_max=self.world_max, y_warm=yw,
                               dtype=self.dtype))
        timeit("traj_optimization", stage_qp, pos, vel, acc,
               state.desired_goal, planes_c,
               self.optimizer.extract_y(init).astype(self.dtype))
        times["total"] = sum(times.values())
        # the production cycle is ONE fused program with no stage
        # boundaries; XLA overlaps/fuses across them, so the honest
        # end-to-end number is measured separately and is usually well
        # below the sum of the isolated stages
        timeit("cycle_fused_end_to_end", self._cycle_jit, state)
        return times

    # ------------------------------------------------------------------
    @exact_f32
    def qp_violation_report(self, prev_state: SwarmState,
                            state: SwarmState, top_k: int = 5) -> dict:
        """Conflict-refinement analog (traj_optimizer.cpp:104-137 +
        traj_planner.cpp:1556-1577): re-derive the cycle's LSC planes
        from the pre-cycle state and report each failing agent's most
        violated (obstacle, segment, ctrl point) rows -- the data the
        reference writes to log/conflict.lp.  Host-side diagnostic."""
        p = self.param
        N = self.N
        pos, vel, acc = self.propagate(prev_state)
        init, prediction = self.predict_and_init(
            prev_state.traj, pos, vel, prev_state.seq,
            prev_goal=prev_state.current_goal)
        obs_pred = jnp.broadcast_to(prediction[None],
                                    (N, N, self.M, self.n + 1, 3))
        planes = cons.lsc_planes(
            init, obs_pred, self.radius, self.downwash,
            jnp.broadcast_to(self.radius[None], (N, N)),
            jnp.broadcast_to(self.downwash[None], (N, N)),
            jnp.ones((N, N), bool), ~jnp.eye(N, dtype=bool),
            guard_margin=p.lsc_guard_margin)
        # margins of the OUTPUT trajectory against every plane row
        lhs = jnp.einsum("ncmd,nmid->ncmi", planes.normal, state.traj)
        viol = jnp.where(planes.mask[..., None],
                         planes.rhs - lhs, -jnp.inf)     # (N, C, M, n+1)
        v = np.asarray(viol)
        report = {}
        failed = np.asarray(state.primal_res) > p.qp_failure_threshold
        for qi in np.where(failed)[0]:
            flat = v[qi].reshape(-1)
            order = np.argsort(flat)[::-1][:top_k]
            rows = []
            for r in order:
                c, rem = divmod(int(r), self.M * (self.n + 1))
                m, i = divmod(rem, self.n + 1)
                rows.append({"obstacle": c, "segment": m, "ctrl_pt": i,
                             "violation": float(flat[r])})
            report[int(qi)] = rows
        return report

    # ------------------------------------------------------------------
    def is_finished(self, state: SwarmState) -> bool:
        """All agents within goal_threshold of their desired goals
        (isFinished, multi_sync_simulator.cpp:358-380); never finishes in
        patrol mode."""
        if self.param.multisim_patrol:
            return False
        d = jnp.linalg.norm(state.pos - state.desired_goal, axis=-1)
        return bool(jnp.max(d) < self.param.goal_threshold)

    # --- service analogs (multi_sync_simulator.cpp:696-728) ---
    def update_goals(self, state: SwarmState, new_goals) -> SwarmState:
        """/update_goal: mission hot-swap of desired goals."""
        return state._replace(
            desired_goal=jnp.asarray(new_goals, self.dtype))

    def go_back(self, state: SwarmState) -> SwarmState:
        """GOBACK: return every agent to its mission start position."""
        return state._replace(start=state.desired_goal,
                              desired_goal=state.start)

    @exact_f32
    def inject_positions(self, state: SwarmState, real_pos) -> SwarmState:
        """Experiment-mode external pose injection with disturbance reset
        (update(), multi_sync_simulator.cpp:210-246): agents whose observed
        position deviates beyond the reset threshold restart from the
        observation with zeroed derivatives and a re-seeded SFC."""
        real_pos = jnp.asarray(real_pos, self.dtype)
        rolled = jax.vmap(lambda tr: bz.traj_state(
            tr, self.param.multisim_time_step, self.param.dt))(state.traj)
        dev = jnp.linalg.norm(rolled["pos"] - real_pos, axis=-1) \
            > self.param.multisim_reset_threshold
        frozen = jnp.broadcast_to(real_pos[:, None, None, :],
                                  state.traj.shape)
        slack = state.slack_flags
        if slack is not None:
            # mark the deviated agents for the next cycle's slack-relaxed
            # QP (obs_slack_indices analog, traj_planner.cpp:866-878)
            slack = slack | dev
        return state._replace(
            traj=jnp.where(dev[:, None, None, None], frozen, state.traj),
            sfc_initialized=state.sfc_initialized & ~dev,
            slack_flags=slack)

    def run(self, max_iterations: Optional[int] = None,
            log: Optional[object] = None,
            cycle_fn=None, profile: bool = False,
            steps_per_dispatch: int = 1) -> dict:
        """Host loop: cycle until all agents reach goals or iteration cap.

        Returns a summary dict in the shape of the reference's summary CSV
        row (saveSummarizedResultAsCSV, multi_sync_simulator.cpp:589-633).
        `cycle_fn` overrides the cycle implementation (e.g. the sharded
        multi-chip cycle from parallel/shard.py).

        `steps_per_dispatch` > 1 fuses that many cycles into one device
        dispatch (make_scan_cycle), amortizing host<->device latency; the
        finishing cycle is still recovered exactly from the per-cycle
        goal distances, but per-cycle host logging/pacing and dynamic
        obstacles are unsupported, and the reported flight distance may
        include sub-cm hover jitter from cycles planned after the finish.
        """
        p = self.param
        if steps_per_dispatch > 1:
            if cycle_fn is not None or log is not None or \
                    self.obstacle_generator is not None or \
                    p.multisim_experiment or p.multisim_planning_rate > 0:
                raise ValueError("steps_per_dispatch > 1 is incompatible "
                                 "with cycle_fn/log/dynamic obstacles/"
                                 "real-time pacing")
            return self._run_fused(max_iterations, steps_per_dispatch,
                                   profile)
        cycle = cycle_fn or self._cycle_jit
        max_iter = max_iterations or p.multisim_max_planner_iteration
        state = self.initial_state()
        t_wall0 = time.perf_counter()
        plan_times = []
        is_collided = False
        flight_time = float("nan")
        iters_done = 0
        qp_failures = 0
        for it in range(max_iter):
            prev_state = state
            t0 = time.perf_counter()
            if self.obstacle_generator is not None:
                # host-side analytic obstacle evaluation
                # (obstacle_generator.hpp:33-54); chasing obstacles pursue
                # the nearest agent
                t_sim = it * p.multisim_time_step
                from .obstacles import ChasingObstacle
                host_pos = np.asarray(state.pos)
                for m in self.obstacle_generator.models:
                    if isinstance(m, ChasingObstacle):
                        d = np.linalg.norm(host_pos - m.pos, axis=-1)
                        m.set_goal_point(host_pos[int(np.argmin(d))])
                dp, dv = self.obstacle_generator.update(t_sim)
                from ..config import PredictionMode as PM
                dyn_pred = None
                if p.prediction_mode == PM.LINEAR_KALMAN_FILTER:
                    # noisy observation -> filtered state
                    # (obstaclePredictionWithLinearKalmanFilter,
                    # traj_planner.cpp:641-695).  With observation noise
                    # each agent runs its OWN filter on its OWN noisy
                    # observation (the reference instantiates the KFs
                    # inside every TrajPlanner and the generator draws
                    # fresh noise per agent message); the per-agent
                    # filtered states become per-agent predictions while
                    # the audit keeps the true positions.
                    per_agent = self.obstacle_generator.noise_std > 0
                    n_f = self.N * self.O_dyn if per_agent else self.O_dyn
                    if not hasattr(self, "_kf"):
                        from .kalman import LinearKalmanFilter
                        self._kf = LinearKalmanFilter(
                            n_f, p.filter_sigma_y_sq,
                            p.filter_sigma_v_sq, p.filter_sigma_a_sq)
                    if per_agent:
                        obs = self.obstacle_generator.observed(self.N)
                        fp, fv = self._kf.filter(obs.reshape(-1, 3),
                                                 t_sim)
                        fp = jnp.asarray(
                            fp.reshape(self.N, self.O_dyn, 3), self.dtype)
                        fv = jnp.asarray(
                            fv.reshape(self.N, self.O_dyn, 3), self.dtype)
                        dyn_pred = pred.constant_velocity_traj(
                            fp, fv, self.M, self.n, p.dt)
                    else:
                        obs = self.obstacle_generator.observed()
                        dp, dv = self._kf.filter(obs, t_sim)
                dyn_pos = jnp.asarray(dp, self.dtype)
                dyn_vel = jnp.asarray(dv, self.dtype)
                if p.prediction_mode == PM.ORACLE:
                    dyn_pred = jnp.asarray(
                        self._oracle_prediction(t_sim), self.dtype)
                if dyn_pred is not None:
                    state, info = cycle(state, dyn_pos, dyn_vel, dyn_pred)
                else:
                    state, info = cycle(state, dyn_pos, dyn_vel)
            else:
                state, info = cycle(state)
            state.traj.block_until_ready()
            plan_times.append(time.perf_counter() - t0)
            iters_done = it + 1
            if float(info.safety_step_min) < 1.0:
                is_collided = True
            if getattr(info, "qp_failed", None) is not None:
                n_failed = int(np.asarray(info.qp_failed).sum())
                if n_failed:
                    # QPFAILED surfacing (multi_sync_simulator.cpp:325-327
                    # analog): report the conflicting rows; the cycle
                    # already substituted the feasible previous solution
                    # for the failing agents
                    qp_failures += n_failed
                    report = self.qp_violation_report(prev_state, state)
                    print(f"[SyncSimulator] QPFAILED at cycle {it}, "
                          f"agents {sorted(report)}; top violations: "
                          f"{report}")
                    if p.multisim_abort_on_qp_failure:
                        print("[SyncSimulator] aborting run "
                              "(multisim_abort_on_qp_failure)")
                        break
            if log is not None:
                if self.obstacle_generator is not None:
                    log.record_cycle(
                        self, state, plan_times[-1],
                        obstacles_pos=self.obstacle_generator._pos,
                        obstacles_radius=self.obstacle_generator.radii)
                else:
                    log.record_cycle(self, state, plan_times[-1])
            if self.is_finished(state):
                flight_time = iters_done * p.multisim_time_step
                break
            if p.multisim_experiment:
                # real-time pacing: warn when planning overruns the cycle
                # budget (multi_sync_simulator.cpp:136-142)
                margin = p.multisim_time_step - plan_times[-1]
                if margin < 0:
                    print(f"[SyncSimulator] planning too slow: "
                          f"{-margin*1e3:.1f} ms over budget")
                else:
                    time.sleep(margin)
            elif p.multisim_planning_rate > 0:
                time.sleep(1.0 / p.multisim_planning_rate)
        wall = time.perf_counter() - t_wall0
        pt = np.asarray(plan_times[1:]) if len(plan_times) > 1 else \
            np.asarray(plan_times)
        return self._summarize(state, pt, wall, iters_done, flight_time,
                               is_collided, profile,
                               qp_failures=qp_failures)

    def _run_fused(self, max_iterations, k: int, profile: bool) -> dict:
        """run() body for steps_per_dispatch = k > 1: blocks of k cycles
        per device dispatch, exact finish detection from the stacked
        per-cycle goal distances."""
        p = self.param
        max_iter = max_iterations or p.multisim_max_planner_iteration
        multi = self.make_scan_cycle(k)
        state = self.initial_state()
        t_wall0 = time.perf_counter()
        plan_times = []
        is_collided = False
        flight_time = float("nan")
        iters_done = 0
        qp_failures = 0
        for block in range((max_iter + k - 1) // k):
            t0 = time.perf_counter()
            state, (info, goal_dist, cum_dist) = multi(state)
            state.traj.block_until_ready()
            plan_times.append((time.perf_counter() - t0) / k)
            gd = np.asarray(goal_dist)
            safety = np.asarray(info.safety_step_min)
            if getattr(info, "qp_failed", None) is not None:
                qp_failures += int(np.asarray(info.qp_failed).sum())
            done = gd < p.goal_threshold
            if not p.multisim_patrol and done.any():
                j = int(np.argmax(done))              # first finished cycle
                iters_done = block * k + j + 1
                flight_time = iters_done * p.multisim_time_step
                is_collided |= bool((safety[:j + 1] < 1.0).any())
                # truncate metrics at the finish cycle (cycles j+1..k-1
                # were planned speculatively inside the block)
                state = state._replace(distance=cum_dist[j])
                break
            iters_done = block * k + k
            is_collided |= bool((safety < 1.0).any())
        wall = time.perf_counter() - t_wall0
        pt = np.asarray(plan_times[1:]) if len(plan_times) > 1 else \
            np.asarray(plan_times)
        return self._summarize(state, pt, wall, iters_done, flight_time,
                               is_collided, profile,
                               qp_failures=qp_failures)

    def _summarize(self, state, pt, wall, iters_done, flight_time,
                   is_collided, profile, qp_failures: int = 0) -> dict:
        p = self.param
        stage_times = {}
        if profile and self.param.planner_mode != PlannerMode.ORCA:
            stage_times = self.profile_stages(state)
        return {
            "stage_times": stage_times,
            "total_flight_time": flight_time,
            "total_flight_distance": float(state.distance),
            "is_collided": bool(is_collided),
            "safety_ratio_agent": float(state.safety_agent_min),
            "safety_ratio_obs": float(state.safety_obs_min),
            "average_planning_time": float(pt.mean()) if pt.size else 0.0,
            "min_planning_time": float(pt.min()) if pt.size else 0.0,
            "max_planning_time": float(pt.max()) if pt.size else 0.0,
            "iterations": iters_done,
            "qp_failures": qp_failures,
            "wall_time": wall,
            "planner_mode": p.planner_mode_str(),
            "final_state": state,
        }

"""Multi-device execution: the swarm sharded over a device mesh.

The reference's distributed story is ROS TCP pub/sub between per-agent
planner nodes (SURVEY.md section 5.8); here the agent axis is sharded over
a ``jax.sharding.Mesh`` and the per-cycle neighbour-trajectory exchange is
one ``all_gather`` of the (N, M, n+1, 3) control-point tensor over the
device interconnect -- the direct analog of update()'s obstacle collection
(multi_sync_simulator.cpp:269-303).

Each shard then plans its local agent block against the gathered global
view with exactly the same `plan_block` code the single-chip path uses.
Scalar audit metrics are computed on gathered positions (replicated).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..sim import audit
from ..runtime import exact_f32
from ..sim.simulator import SwarmState, CycleInfo, SyncSimulator

AGENT_AXIS = "agents"
HOST_AXIS = "hosts"          # outer (between-host) axis of the 2-axis mesh


def make_mesh(n_devices: Optional[int] = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AGENT_AXIS,))


def make_mesh_2d(n_hosts: int, chips_per_host: Optional[int] = None,
                 devices=None) -> Mesh:
    """2-axis mesh (hosts, chips): the slow outer axis maps to the
    network between hosts, the fast inner axis to the links within a
    host.  Device order is host-major (jax.devices() already groups by
    process), so the linearized agent order keeps each host's agents
    contiguous and the between-host traffic of the hierarchical exchange
    is one block halo per host pair instead of the full swarm."""
    devices = list(devices if devices is not None else jax.devices())
    if chips_per_host is None:
        chips_per_host = len(devices) // n_hosts
    devices = devices[:n_hosts * chips_per_host]
    arr = np.asarray(devices).reshape(n_hosts, chips_per_host)
    return Mesh(arr, (HOST_AXIS, AGENT_AXIS))


def state_specs(axes=AGENT_AXIS) -> SwarmState:
    """PartitionSpecs for SwarmState: per-agent fields sharded over
    `axes` (one mesh axis name or a tuple for the 2-axis mesh), scalars
    replicated."""
    sharded = P(axes)
    rep = P()
    return SwarmState(traj=sharded, pos=sharded, vel=sharded, acc=sharded,
                      current_goal=sharded, seq=rep, qp_cost=sharded,
                      primal_res=sharded, safety_agent_min=rep,
                      distance=rep, sfc=sharded, sfc_initialized=sharded,
                      start=sharded, desired_goal=sharded,
                      safety_obs_min=rep, stall_count=sharded,
                      rescue_goal=sharded, rescue_active=sharded,
                      rescue_phase=sharded, slack_flags=sharded,
                      path_floor=sharded, best_goal_dist=sharded)


def _ring_halo(x, halo: int, n_ring: int, axis: str = AGENT_AXIS):
    """Gather the (2*halo+1)-shard neighbourhood of a per-shard block via
    lax.ppermute ring steps over mesh axis `axis`: offset-ordered blocks
    [-halo..halo].

    This is the CP/ring analog from SURVEY.md section 5.7: with the swarm
    kept spatially sorted (see `spatial_sort_state`), agents outside the
    halo window cannot enter the LSC interaction ball within a horizon,
    so a band exchange over neighbouring shards replaces the O(N)
    all_gather AND bounds the downstream K-NN distance matrix at
    (L, (2*halo+1)*L) instead of (L, N).
    """
    fwd = [(i, (i + 1) % n_ring) for i in range(n_ring)]  # recv from left
    bwd = [(i, (i - 1) % n_ring) for i in range(n_ring)]  # recv from right
    left, right = {}, {}
    xl = xr = x
    for h in range(1, halo + 1):
        xl = jax.lax.ppermute(xl, axis, fwd)       # block of shard-h
        xr = jax.lax.ppermute(xr, axis, bwd)       # block of shard+h
        left[h], right[h] = xl, xr
    blocks = [left[h] for h in range(halo, 0, -1)] + [x] + \
        [right[h] for h in range(1, halo + 1)]
    return jnp.concatenate(blocks, axis=0)


def make_sharded_cycle(sim: SyncSimulator, mesh: Mesh,
                       halo_shards: Optional[int] = None):
    """Build the jitted multi-chip cycle: state sharded over the agent
    axis; one all_gather per cycle for the trajectory exchange.

    halo_shards = H switches the exchange from the full all_gather to a
    ring-halo of the 2H+1 neighbouring shards (ppermute).
    Requires 2H+1 <= mesh size, spatially sorted agent order (re-sort
    with `spatial_sort_state` between cycles as the swarm moves), and a
    homogeneous swarm (uniform radius/downwash/limits) since sorting
    permutes rows; the exact safety audit stays global either way.

    A 2-axis mesh from `make_mesh_2d` switches to the hierarchical
    (multi-host) layout: agents sharded over (hosts, chips), the
    trajectory exchange an all_gather within each host, and -- with
    halo_shards = H -- a host-block ring halo over the host axis, so
    cross-host traffic is 2H boundary blocks per host instead of the
    whole swarm.

    The cycle is traced under the planner's full-f32 matmul policy
    (runtime.exact_f32)."""
    p = sim.param
    N = sim.N
    two_level = tuple(mesh.axis_names) == (HOST_AXIS, AGENT_AXIS)
    axes = (HOST_AXIS, AGENT_AXIS) if two_level else AGENT_AXIS
    n_dev = mesh.devices.size
    if N % n_dev != 0:
        raise ValueError(f"agent count {N} must be divisible by the mesh "
                         f"size {n_dev} (pad the mission)")
    L = N // n_dev
    if two_level:
        n_hosts, ici = mesh.devices.shape
    if halo_shards is not None:
        n_ring = n_hosts if two_level else n_dev
        if 2 * halo_shards + 1 > n_ring:
            raise ValueError("halo window exceeds the ring "
                             f"(2*{halo_shards}+1 > {n_ring})")
        for arr in (sim.radius, sim.downwash, sim.nominal_velocity,
                    sim.max_vel, sim.max_acc):
            a = np.asarray(arr)
            if not np.allclose(a, a[:1]):
                raise ValueError("ring-halo exchange requires a "
                                 "homogeneous swarm (spatial sorting "
                                 "permutes agent rows)")

    specs = state_specs(axes)

    def body(state: SwarmState, dyn_pos=None, dyn_vel=None):
        # local block: (L, ...) per-agent leaves
        if two_level:
            shard = (jax.lax.axis_index(HOST_AXIS) * ici +
                     jax.lax.axis_index(AGENT_AXIS))
        else:
            shard = jax.lax.axis_index(AGENT_AXIS)
        my_ids = shard * L + jnp.arange(L)

        pos_l, vel_l, acc_l = sim.propagate(state)
        # patrol start/goal swap (purely per-agent; same code as the
        # single-chip cycle, traj_planner.cpp:479-485)
        start_l, desired_goal_l = sim._patrol_swap(state, pos_l)
        from ..sim.simulator import _update_stall_count, _update_rescue, \
            _no_rescue
        goal_changed = jnp.any(desired_goal_l != state.desired_goal,
                               axis=-1)
        best_prev = jnp.where(goal_changed, jnp.inf, state.best_goal_dist)
        stall_count, progress, progress_best, best_goal_dist = \
            _update_stall_count(state.stall_count, best_prev, state.pos,
                                pos_l, vel_l, desired_goal_l, state.seq, p,
                                has_static=sim.esdf is not None)
        if p.deadlock_rescue:
            # full candidate validation as on the single chip: without
            # the ESDF/world-bounds checks a rescue waypoint can latch
            # inside an obstacle on octomap worlds (the round-3 gap)
            rescue_goal, rescue_active, rescue_phase, stall_count = \
                _update_rescue(state, pos_l, desired_goal_l,
                               stall_count, progress, p, esdf=sim.esdf,
                               radius=jnp.asarray(sim.radius)[my_ids],
                               world_min=sim.world_min,
                               world_max=sim.world_max,
                               progress_best=progress_best)
        else:
            rescue_goal, rescue_active, rescue_phase = _no_rescue(state)
        init_l, pred_l = sim.predict_and_init(state.traj, pos_l, vel_l,
                                              state.seq,
                                              prev_goal=state.current_goal)

        # --- the communication step: neighbour trajectory exchange ---
        obs_attrs = {}
        if halo_shards is None:
            pred_g = jax.lax.all_gather(pred_l, axes, tiled=True)
            pos_g = jax.lax.all_gather(pos_l, axes, tiled=True)
            prev_g = jax.lax.all_gather(state.traj, axes, tiled=True)
            goal_g = jax.lax.all_gather(desired_goal_l, axes,
                                        tiled=True)
            self_mask = my_ids[:, None] == jnp.arange(N)[None, :]
        elif two_level:
            # intra-host all_gather, host-block halo between hosts
            H = halo_shards
            Lh = ici * L                       # agents per host

            def view(x):
                xg = jax.lax.all_gather(x, AGENT_AXIS, tiled=True)
                return _ring_halo(xg, H, n_hosts, axis=HOST_AXIS)
            pred_g = view(pred_l)
            pos_g = view(pos_l)
            prev_g = view(state.traj)
            goal_g = view(desired_goal_l)
            V = (2 * H + 1) * Lh
            col = jnp.arange(V)
            local = jax.lax.axis_index(AGENT_AXIS) * L + jnp.arange(L)
            self_mask = ((col[None, :] // Lh == H) &
                         (col[None, :] % Lh == local[:, None]))
        else:
            H = halo_shards
            pred_g = _ring_halo(pred_l, H, n_dev)
            pos_g = _ring_halo(pos_l, H, n_dev)
            prev_g = _ring_halo(state.traj, H, n_dev)
            goal_g = _ring_halo(desired_goal_l, H, n_dev)
            V = (2 * H + 1) * L
            # self block sits at offset index H in the view
            col = jnp.arange(V)
            self_mask = ((col[None, :] // L == H) &
                         (col[None, :] % L == jnp.arange(L)[:, None]))
        if halo_shards is not None:
            # homogeneous swarm (checked above): view attributes are
            # uniform regardless of the sorted order
            obs_attrs = dict(
                obs_radius_global=jnp.broadcast_to(sim.radius[:1], (V,)),
                obs_downwash_global=jnp.broadcast_to(sim.downwash[:1],
                                                     (V,)),
                obs_maxacc_global=jnp.broadcast_to(sim.max_acc[:1, 0],
                                                   (V,)))

        sfc_initialize = ~state.sfc_initialized
        sfc_seed = jnp.where(sfc_initialize[:, None], pos_l,
                             state.traj[:, -1, -1, :])
        res, current_goal, sfc, _knn_ovf, path_floor = sim.plan_block(
            pos_l, vel_l, acc_l, init_l, state.seq,
            pred_global=pred_g, obs_pos_global=pos_g,
            obs_goal_global=goal_g,
            obs_prev_global=prev_g,
            self_mask=self_mask,
            radius=sim.radius[my_ids], downwash=sim.downwash[my_ids],
            nominal_velocity=sim.nominal_velocity[my_ids],
            max_vel=sim.max_vel[my_ids], max_acc=sim.max_acc[my_ids],
            desired_goal=desired_goal_l,
            sfc_prev=state.sfc, sfc_initialize=sfc_initialize,
            sfc_seed=sfc_seed, rescue_goal=rescue_goal,
            rescue_active=rescue_active, dyn_pos=dyn_pos,
            dyn_vel=dyn_vel, **obs_attrs)

        # QPFAILED feasible fallback, identical to the single-chip cycle
        # (traj_optimizer.cpp:99-144 analog): a violating solution is
        # replaced by the shifted previous solution, which is feasible
        # for every LSC plane by construction -- one bad solve cannot
        # poison the swarm through next cycle's gathered predictions.
        qp_failed = res.primal_res > p.qp_failure_threshold
        res = res._replace(traj=jnp.where(qp_failed[:, None, None, None],
                                          init_l, res.traj))

        # --- audit on gathered sampled positions (replicated scalar) ---
        ts = audit._sample_times(p.multisim_record_time_step,
                                 p.multisim_time_step, inclusive=True)
        pos_samples_l = audit.positions_at(res.traj, ts, p.dt)  # (T, L, 3)
        pos_samples = jax.lax.all_gather(pos_samples_l, axes,
                                         tiled=True, axis=1)    # (T, N, 3)
        safety_step = jnp.min(audit.pairwise_safety_ratio(
            pos_samples[:-1], sim.radius, sim.downwash))
        seg = jnp.linalg.norm(jnp.diff(pos_samples, axis=0), axis=-1)
        step_dist = jnp.sum(seg)

        # dynamic-obstacle + static-box safety audit (replicated min,
        # multi_sync_simulator.cpp:446-503 parity with the single chip)
        obs_safety = state.safety_obs_min
        if sim.O_dyn and dyn_pos is not None:
            local_min = audit.obstacle_safety_ratio(
                pos_l, dyn_pos, sim.radius[my_ids], sim.obs_radius_dyn)
            obs_safety = jnp.minimum(
                obs_safety, jax.lax.pmin(local_min, axes))
        if sim.static_boxes.shape[0]:
            local_min = audit.static_box_safety_ratio(
                pos_l, sim.static_boxes, sim.radius[my_ids])
            obs_safety = jnp.minimum(
                obs_safety, jax.lax.pmin(local_min, axes))

        new_state = SwarmState(
            traj=res.traj, pos=pos_l, vel=vel_l, acc=acc_l,
            current_goal=current_goal, seq=state.seq + 1,
            qp_cost=res.cost, primal_res=res.primal_res,
            safety_agent_min=jnp.minimum(state.safety_agent_min,
                                         safety_step),
            distance=state.distance + step_dist,
            sfc=sfc if sfc is not None else state.sfc,
            sfc_initialized=jnp.ones_like(state.sfc_initialized),
            start=start_l, desired_goal=desired_goal_l,
            safety_obs_min=obs_safety,
            stall_count=stall_count, rescue_goal=rescue_goal,
            rescue_active=rescue_active, rescue_phase=rescue_phase,
            slack_flags=state.slack_flags, path_floor=path_floor,
            best_goal_dist=best_goal_dist)
        info = CycleInfo(safety_step_min=safety_step, qp_cost=res.cost,
                         primal_res=res.primal_res, qp_failed=qp_failed)
        return new_state, info

    info_specs = CycleInfo(safety_step_min=P(), qp_cost=P(axes),
                           primal_res=P(axes), qp_failed=P(axes))
    if sim.O_dyn:
        sharded = shard_map(body, mesh=mesh,
                            in_specs=(specs, P(), P()),
                            out_specs=(specs, info_specs),
                            check_vma=False)
    else:
        sharded = shard_map(lambda s: body(s), mesh=mesh,
                            in_specs=(specs,),
                            out_specs=(specs, info_specs),
                            check_vma=False)
    return jax.jit(exact_f32(sharded))


def _part1by2(x):
    """Spread the low 10 bits of x two apart (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(pos, world_min, world_max):
    """30-bit Morton (Z-order) codes of positions over the world bbox."""
    span = jnp.maximum(jnp.asarray(world_max) - jnp.asarray(world_min),
                       1e-9)
    q = jnp.clip((pos - jnp.asarray(world_min)) / span, 0.0, 1.0) * 1023.0
    q = q.astype(jnp.uint32)
    return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) |
            (_part1by2(q[:, 2]) << 2))


def spatial_sort_state(state: SwarmState, world_min, world_max,
                       key: str = "morton") -> SwarmState:
    """Reorder the swarm spatially so shard-adjacency tracks spatial
    adjacency for the ring-halo exchange of
    `make_sharded_cycle(..., halo_shards=H)`.

    key = "morton": Z-order curve of positions -- good for roughly
    isotropic swarms, but any 1-D curve has boundary artifacts (two close
    points can straddle a high-bit boundary and sort far apart).
    key = "axis:k": plain sort along coordinate k -- exact adjacency for
    swarms elongated along one axis (corridor / lane missions), where the
    window bound is simply the halo span along that axis.

    All per-agent state (goals, SFC, deadlock bookkeeping) travels with
    its agent; requires a homogeneous swarm (the simulator's per-agent
    attribute arrays are not permuted).  Re-apply every few cycles as the
    swarm moves; jit-able (lowers to an all-to-all on a sharded state).
    """
    if key.startswith("axis:"):
        perm = jnp.argsort(state.pos[:, int(key.split(":")[1])])
    else:
        perm = jnp.argsort(morton_codes(state.pos, world_min, world_max))
    specs = state_specs()
    return jax.tree.map(
        lambda x, s: x[perm] if s == P(AGENT_AXIS) else x, state, specs)


def _mesh_axes(mesh: Mesh):
    return ((HOST_AXIS, AGENT_AXIS)
            if tuple(mesh.axis_names) == (HOST_AXIS, AGENT_AXIS)
            else AGENT_AXIS)


def shard_state(state: SwarmState, mesh: Mesh) -> SwarmState:
    """Place a host-built initial state onto the mesh with the cycle's
    shardings."""
    specs = state_specs(_mesh_axes(mesh))
    return jax.tree.map(
        lambda x, s: jax.device_put(
            x, jax.sharding.NamedSharding(mesh, s)), state, specs)


def profile_sharded(sim: SyncSimulator, mesh: Mesh,
                    halo_shards: Optional[int] = None,
                    n_cycles: int = 5) -> dict:
    """Per-stage device timing for the SHARDED cycle (the multi-chip
    counterpart of SyncSimulator.profile_stages, reference stage taxonomy
    include/sp_const.hpp:89-128).

    The fused production cycle has no stage boundaries, so -- like the
    single-chip profiler -- each number times a separately-jitted
    shard_map program: the neighbour-trajectory exchange (all_gather or
    ring halo: THE communication step, the reference's ROS-topic
    analog), the full cycle, and the derived local-compute share.
    Returns times in seconds per cycle.
    """
    import time as _time

    p = sim.param
    two_level = tuple(mesh.axis_names) == (HOST_AXIS, AGENT_AXIS)
    axes = (HOST_AXIS, AGENT_AXIS) if two_level else AGENT_AXIS
    n_dev = mesh.devices.size
    specs = state_specs(axes)
    cycle = make_sharded_cycle(sim, mesh, halo_shards=halo_shards)
    state = shard_state(sim.initial_state(), mesh)

    def exchange(state: SwarmState):
        pred_l = state.traj
        if halo_shards is None:
            return jax.lax.all_gather(pred_l, axes, tiled=True)
        if two_level:
            xg = jax.lax.all_gather(pred_l, AGENT_AXIS, tiled=True)
            return _ring_halo(xg, halo_shards, mesh.devices.shape[0],
                              axis=HOST_AXIS)
        return _ring_halo(pred_l, halo_shards, n_dev)

    exchange_j = jax.jit(shard_map(
        exchange, mesh=mesh, in_specs=(specs,), out_specs=P(),
        check_vma=False))

    def timeit(fn, *args):
        out = fn(*args)
        jax.tree.map(lambda x: x.block_until_ready()
                     if hasattr(x, "block_until_ready") else x, out)
        t0 = _time.perf_counter()
        for _ in range(n_cycles):
            out = fn(*args)
            jax.tree.map(lambda x: x.block_until_ready()
                         if hasattr(x, "block_until_ready") else x, out)
        return (_time.perf_counter() - t0) / n_cycles

    t_cycle = timeit(cycle, state)
    t_exch = timeit(exchange_j, state)
    return {
        "exchange": t_exch,
        "cycle_total": t_cycle,
        "local_compute_est": max(t_cycle - t_exch, 0.0),
        "n_devices": int(n_dev),
        "halo_shards": halo_shards,
    }

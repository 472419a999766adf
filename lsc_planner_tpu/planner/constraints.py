"""Batched collision-constraint construction: LSC, BVC, RSFC, SFC planes.

Reference: TrajPlanner::generateLSC / generateBVC / generateReciprocalRSFC
(src/traj_planner.cpp:1254-1440) and Box::convertToLSCs
(src/collision_constraints.cpp:37-59).  The reference loops over
(obstacle, segment) pairs calling GJK one pair at a time; here each
generator is a single batched tensor program over every (agent, obstacle,
segment) triple at once, feeding the unified PlaneConstraints rows consumed
by the QP assembly.
"""
from __future__ import annotations

import jax.numpy as jnp

# Every einsum touching ABSOLUTE positions (obs_pred, init_traj live at
# world coordinates up to ~150 m) must run at full f32: TF32 keeps ~11
# bits, a ~7 cm quantum at those magnitudes, which would corrupt plane
# offsets.  The cycle entry points trace these under
# jax.default_matmul_precision("highest") (runtime.exact_f32).

from ..ops import geometry as geo
from ..ops import hull as hull_ops
from .optimizer import PlaneConstraints


def pair_downwash(agent_radius, agent_downwash, obs_radius, obs_downwash,
                  obs_is_agent):
    """Combined downwash for agent-vs-obstacle (traj_planner.cpp:1336-1345):
    agents mix both coefficients; non-agents use 1.0 for the ego agent."""
    dw_agent = ((agent_downwash * agent_radius + obs_downwash * obs_radius)
                / (agent_radius + obs_radius))
    dw_other = ((agent_radius + obs_downwash * obs_radius)
                / (agent_radius + obs_radius))
    return jnp.where(obs_is_agent, dw_agent, dw_other)


def lsc_planes(init_traj, obs_pred, agent_radius, agent_downwash,
               obs_radius, obs_downwash, obs_is_agent, obs_mask,
               slack_flags=None, obs_pred_sizes=None,
               guard_margin: float = 0.0) -> PlaneConstraints:
    """Linear Safe Corridor planes for all (agent, obstacle, segment).

    init_traj: (N, M, n+1, 3)   agent initial trajectories
    obs_pred:  (N, O, M, n+1, 3) per-agent predicted obstacle trajectories
    agent_radius/downwash: (N,);  obs_radius/downwash: (N, O)
    obs_is_agent, obs_mask: (N, O) bool;  slack_flags: (N, O) bool or None
    obs_pred_sizes: (N, O, M, n+1) inflated radii (used for slack rows)
    guard_margin: feasibility-preserving f32 guard band (metres); see below

    Implements generateLSC (traj_planner.cpp:1310-1407): downwash coordinate
    transform, hull closest-point normal between relative control points,
    margin d_i = 0.5 (r_i + r_j + rel_i . n), z-untransform of the normal.

    The guard band (no reference equivalent -- CPLEX solves the QP in f64
    to ~1e-9 feasibility and needs none): a capped f32 interior-point solve
    can leave mm-scale primal error, which at congested steady state shows
    up as safety ratios one ulp either side of 1.0.  Each row's margin is
    inflated by ``min(guard_margin, s0/2)`` where ``s0 = (rel_i.n - r)/2``
    is that row's slack at the initial trajectory.  The clamp keeps the
    shifted-previous-solution feasibility lemma intact exactly (remaining
    slack >= s0/2 >= 0), so the guard can never make the QP infeasible; it
    only pushes the congestion equilibrium separation from "touching" to
    ~2*guard_margin of clearance.
    """
    N, O, M = obs_pred.shape[:3]
    n1 = obs_pred.shape[3]

    dw = pair_downwash(agent_radius[:, None], agent_downwash[:, None],
                       obs_radius, obs_downwash, obs_is_agent)  # (N, O)
    scale = jnp.stack([jnp.ones_like(dw), jnp.ones_like(dw), 1.0 / dw],
                      axis=-1)                                   # (N, O, 3)
    init_t = init_traj[:, None] * scale[:, :, None, None, :]
    obs_t = obs_pred * scale[:, :, None, None, :]

    rel = init_t - obs_t                                   # (N, O, M, n1, 3)
    normal_t, dist = hull_ops.hull_normal(rel)             # (N, O, M, 3)

    collision_dist = agent_radius[:, None] + obs_radius    # (N, O)
    e = jnp.einsum("nomid,nomd->nomi", rel, normal_t)      # rel_i . n_t
    d = 0.5 * (collision_dist[..., None, None] + e)

    if guard_margin > 0.0:
        s0 = 0.5 * (e - collision_dist[..., None, None])   # init-traj slack
        d = d + jnp.clip(0.5 * s0, 0.0, guard_margin)

    if slack_flags is not None and obs_pred_sizes is not None:
        # disturbance path (traj_planner.cpp:1395-1400): reciprocal-RSFC
        # style margin for slack-marked non-agent obstacles
        use_rsfc = slack_flags & ~obs_is_agent
        d_rsfc = obs_pred_sizes + agent_radius[:, None, None, None]
        d = jnp.where(use_rsfc[..., None, None], d_rsfc, d)

    # untransform normal (z divided by downwash, traj_planner.cpp:1403)
    normal = jnp.concatenate(
        [normal_t[..., :2],
         normal_t[..., 2:3] / dw[..., None, None]], axis=-1)

    # rhs_i = d_i + n . p_obs_i  with untransformed obstacle points
    rhs = d + jnp.einsum("nomid,nomd->nomi", obs_pred, normal)
    mask = jnp.broadcast_to(obs_mask[..., None], (N, O, M))
    return PlaneConstraints(normal=normal, rhs=rhs, mask=mask)


def bvc_planes(init_traj, obs_pred, agent_radius, agent_downwash,
               obs_radius, obs_downwash, obs_is_agent,
               obs_mask) -> PlaneConstraints:
    """Buffered Voronoi Cell planes (generateBVC,
    traj_planner.cpp:1409-1440): one normal per obstacle from the current
    relative position, replicated across segments."""
    N, O, M = obs_pred.shape[:3]
    n1 = obs_pred.shape[3]
    dw = ((agent_downwash[:, None] * agent_radius[:, None] +
           obs_downwash * obs_radius) /
          (agent_radius[:, None] + obs_radius))
    scale = jnp.stack([jnp.ones_like(dw), jnp.ones_like(dw), 1.0 / dw],
                      axis=-1)
    p_agent = init_traj[:, 0, 0, :]                      # (N, 3)
    p_obs = obs_pred[:, :, 0, 0, :]                      # (N, O, 3)
    rel = (p_agent[:, None] - p_obs) * scale
    nrm = jnp.linalg.norm(rel, axis=-1, keepdims=True)
    normal_t = rel / jnp.maximum(nrm, 1e-10)
    collision_dist = agent_radius[:, None] + obs_radius
    d = 0.5 * (collision_dist + jnp.einsum("nod,nod->no", rel, normal_t))
    normal = jnp.concatenate([normal_t[..., :2],
                              normal_t[..., 2:3] / dw[..., None]], axis=-1)
    normal_m = jnp.broadcast_to(normal[:, :, None, :], (N, O, M, 3))
    rhs = d[:, :, None, None] + jnp.einsum("nomid,nomd->nomi", obs_pred,
                                           normal_m)
    mask = jnp.broadcast_to(obs_mask[..., None], (N, O, M))
    return PlaneConstraints(normal=normal_m, rhs=rhs, mask=mask)


def rsfc_planes(init_traj, obs_pred, obs_pred_sizes, agent_radius,
                agent_downwash, obs_radius, obs_downwash, obs_is_agent,
                obs_mask) -> PlaneConstraints:
    """Reciprocal RSFC planes (generateReciprocalRSFC,
    traj_planner.cpp:1254-1307, the RA-L 2021 baseline): normal from the
    closest points of the *linear* relative paths between segment endpoints;
    margin from inflated obstacle sizes; z divided by downwash^2."""
    N, O, M = obs_pred.shape[:3]
    obs_start = obs_pred[..., 0, :]                      # (N, O, M, 3)
    obs_goal = obs_pred[..., -1, :]
    a_start = jnp.broadcast_to(init_traj[:, None, :, 0, :], obs_start.shape)
    a_goal = jnp.broadcast_to(init_traj[:, None, :, -1, :], obs_goal.shape)
    normal, closest_dist = geo.normal_vector_between_paths(
        obs_start, obs_goal, a_start, a_goal)

    r_sum = obs_pred_sizes + agent_radius[:, None, None, None]
    near = (obs_is_agent[..., None, None] &
            (closest_dist[..., None] < r_sum))
    d = jnp.where(near, 0.5 * (r_sum + closest_dist[..., None]), r_sum)

    dw = pair_downwash(agent_radius[:, None], agent_downwash[:, None],
                       obs_radius, obs_downwash, obs_is_agent)
    normal = jnp.concatenate(
        [normal[..., :2], normal[..., 2:3] / (dw ** 2)[..., None, None]],
        axis=-1)
    rhs = d + jnp.einsum("nomid,nomd->nomi", obs_pred, normal)
    mask = jnp.broadcast_to(obs_mask[..., None], (N, O, M))
    return PlaneConstraints(normal=normal, rhs=rhs, mask=mask)


def sfc_planes(boxes, active, init_traj=None,
               guard_margin: float = 0.0) -> PlaneConstraints:
    """Safe Flight Corridor box faces as planes.

    boxes: (N, M, 6) as [min_xyz, max_xyz]; active: (N,) or scalar bool.
    Each segment box contributes 2*dim rows (Box::convertToLSCs,
    collision_constraints.cpp:37-59): +e_k with rhs box_min_k, -e_k with
    rhs -box_max_k, obs point at origin.

    guard_margin (with init_traj (N, M, n+1, 3)): the same
    feasibility-preserving f32 guard band as lsc_planes -- each face is
    pulled in by min(guard, s0/2), s0 = that control point's slack at
    the initial trajectory, so mm-scale QP error can no longer leave an
    agent outside its corridor (inside the static-obstacle margin, where
    the SFC seed would freeze; see world/corridor.escape_seeds).
    """
    N, M = boxes.shape[:2]
    dtype = boxes.dtype
    eye = jnp.eye(3, dtype=dtype)
    normals = jnp.concatenate([eye, -eye], axis=0)        # (6, 3)
    normal = jnp.broadcast_to(normals[None, :, None, :], (N, 6, M, 3))
    rhs_min = boxes[..., :3]                              # (N, M, 3)
    rhs_max = -boxes[..., 3:]
    rhs = jnp.concatenate([rhs_min, rhs_max], axis=-1)    # (N, M, 6)
    rhs = jnp.transpose(rhs, (0, 2, 1))                   # (N, 6, M)
    rhs = rhs[..., None]                                  # per ctrl point
    if guard_margin > 0.0 and init_traj is not None:
        lhs0 = jnp.einsum("kd,nmid->nkmi", normals, init_traj)
        s0 = lhs0 - rhs                                   # (N, 6, M, n+1)
        rhs = rhs + jnp.clip(0.5 * s0, 0.0, guard_margin)
    n1 = rhs.shape[-1]
    active = jnp.broadcast_to(jnp.asarray(active), (N,))
    mask = jnp.broadcast_to(active[:, None, None], (N, 6, M))
    return PlaneConstraints(
        normal=normal,
        rhs=jnp.broadcast_to(rhs, (N, 6, M, n1)),
        mask=mask)


def box_pair_planes(hull_points, box1_min, box1_max, box2_min, box2_max,
                    eps=1e-6):
    """Extra LSC planes for a two-box SFC transition (SFC::update,
    collision_constraints.cpp:232-331): for every edge of the box
    intersection that lies on both boxes' boundaries but not on the
    union's, add a half-space separating the control-point hull from the
    incut corner.  Host-side numpy (the reference keeps this in its
    container API; the LSC-mode planner path never calls it).

    Returns (points (E, 3), normals (E, 3)) defining planes
    {x : n . (x - p) >= 0}, or empty arrays when the transition is
    invalid (boxes disjoint / hull escaping both boxes).
    """
    import numpy as onp
    hull_points = onp.asarray(hull_points, float)
    b1 = (onp.asarray(box1_min, float), onp.asarray(box1_max, float))
    b2 = (onp.asarray(box2_min, float), onp.asarray(box2_max, float))
    inter_min = onp.maximum(b1[0], b2[0])
    inter_max = onp.minimum(b1[1], b2[1])
    uni_min = onp.minimum(b1[0], b2[0])
    uni_max = onp.maximum(b1[1], b2[1])
    if onp.any(inter_min > inter_max - eps):
        return onp.zeros((0, 3)), onp.zeros((0, 3))

    def in_box(p, lo, hi):
        return bool(onp.all(p > lo - eps) and onp.all(p < hi + eps))

    for pt in hull_points:
        if not (in_box(pt, *b1) or in_box(pt, *b2)):
            return onp.zeros((0, 3)), onp.zeros((0, 3))

    def box_edges(lo, hi):
        edges = []
        for ax in range(3):
            o1, o2 = (ax + 1) % 3, (ax + 2) % 3
            for a in (lo[o1], hi[o1]):
                for b in (lo[o2], hi[o2]):
                    s = onp.zeros(3); e = onp.zeros(3)
                    s[ax], e[ax] = lo[ax], hi[ax]
                    s[o1] = e[o1] = a
                    s[o2] = e[o2] = b
                    edges.append((s, e))
        return edges

    def on_boundary(s, e, lo, hi):
        # line segment lies on a face plane of [lo, hi] and within it
        for p in (s, e):
            if not in_box(p, lo, hi):
                return False
        for ax in range(3):
            if abs(s[ax] - e[ax]) < eps and (
                    abs(s[ax] - lo[ax]) < eps or abs(s[ax] - hi[ax]) < eps):
                return True
        return False

    verts = []
    for ix in (inter_min[0], inter_max[0]):
        for iy in (inter_min[1], inter_max[1]):
            for iz in (inter_min[2], inter_max[2]):
                verts.append(onp.asarray([ix, iy, iz]))

    pts_out, nrm_out = [], []
    for (s, e) in box_edges(inter_min, inter_max):
        if not (on_boundary(s, e, *b1) and on_boundary(s, e, *b2)):
            continue
        if on_boundary(s, e, uni_min, uni_max):
            continue
        d = e - s
        dn = d / max(onp.linalg.norm(d), eps)
        proj = []
        for pt in hull_points:
            r = pt - s
            proj.append(r - dn * dn.dot(r))
        for v in verts:
            if onp.linalg.norm(s - v) < eps or onp.linalg.norm(e - v) < eps:
                continue
            r = v - s
            proj.append(r - dn * dn.dot(r))
        proj = onp.stack(proj)
        import jax.numpy as jnp_
        closest, dist = hull_ops.closest_point_to_hull(
            jnp_.asarray(proj[None]))
        closest = onp.asarray(closest)[0]
        dist = float(dist[0])
        if dist > eps:
            normal = closest / dist
        else:
            # degenerate: pick a supporting direction from the projected
            # set (collision_constraints.cpp:290-327)
            normal = None
            for pr in proj:
                if onp.linalg.norm(pr) < eps:
                    continue
                cand = onp.cross(pr, dn)
                nc = onp.linalg.norm(cand)
                if nc < eps:
                    continue
                cand = cand / nc
                for sign in (1.0, -1.0):
                    if onp.all(proj.dot(sign * cand) > -eps):
                        normal = sign * cand
                        break
                if normal is not None:
                    break
            if normal is None:
                return onp.zeros((0, 3)), onp.zeros((0, 3))
        pts_out.append(s)
        nrm_out.append(normal)
    if not pts_out:
        return onp.zeros((0, 3)), onp.zeros((0, 3))
    return onp.stack(pts_out), onp.stack(nrm_out)


def concat_planes(*plane_sets, n_ctrl: int) -> PlaneConstraints:
    """Concatenate plane sets along the constraint axis, broadcasting rhs to
    (N, C, M, n_ctrl)."""
    normals, rhss, masks = [], [], []
    for ps in plane_sets:
        if ps is None:
            continue
        N, C, M = ps.normal.shape[:3]
        rhs = jnp.broadcast_to(ps.rhs, (N, C, M, n_ctrl)) \
            if ps.rhs.shape[-1] != n_ctrl else ps.rhs
        normals.append(ps.normal)
        rhss.append(rhs)
        masks.append(ps.mask)
    return PlaneConstraints(normal=jnp.concatenate(normals, axis=1),
                            rhs=jnp.concatenate(rhss, axis=1),
                            mask=jnp.concatenate(masks, axis=1))

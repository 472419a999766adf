"""Batched closest-point geometry (reference ``include/geometry.hpp``).

Every primitive is a pure elementwise/vmap-able function of fixed-shape
inputs; no branching on traced data (selects via jnp.where), so everything
stays inside a single XLA program.
"""
from __future__ import annotations

import jax.numpy as jnp

from .hull import closest_point_to_hull, hull_normal  # re-export


def closest_point_on_segment(point, a, b, eps=1e-12):
    """Closest point on segment [a, b] to `point`; all (..., 3).

    Returns (closest (..., 3), dist (...,)).  Mirrors
    closestPointsBetweenPointAndLineSegment (geometry.hpp:57-93).
    """
    ab = b - a
    denom = jnp.sum(ab * ab, axis=-1, keepdims=True)
    t = jnp.sum((point - a) * ab, axis=-1, keepdims=True) / jnp.maximum(
        denom, eps)
    t = jnp.clip(t, 0.0, 1.0)
    closest = a + t * ab
    dist = jnp.linalg.norm(point - closest, axis=-1)
    return closest, dist


def closest_between_linear_paths(p1_start, p1_goal, p2_start, p2_goal,
                                 eps=1e-12):
    """Minimum over alpha in [0,1] of ||(p1(a) - p2(a))||, i.e. the two
    points move simultaneously along their segments (reference
    closestPointsBetweenLinePaths, geometry.hpp:96-121).

    Returns (closest1, closest2, dist).
    """
    rel_start = p2_start - p1_start
    rel_goal = p2_goal - p1_goal
    origin = jnp.zeros_like(rel_start)
    rel_closest, dist = closest_point_on_segment(origin, rel_start, rel_goal,
                                                 eps)
    seg = rel_goal - rel_start
    seg_len = jnp.linalg.norm(seg, axis=-1, keepdims=True)
    alpha = jnp.where(seg_len > eps,
                      jnp.linalg.norm(rel_closest - rel_start, axis=-1,
                                      keepdims=True) / jnp.maximum(seg_len,
                                                                   eps),
                      jnp.zeros_like(seg_len))
    closest1 = p1_start + (p1_goal - p1_start) * alpha
    closest2 = p2_start + (p2_goal - p2_start) * alpha
    return closest1, closest2, dist


def normal_vector_between_paths(obs_start, obs_goal, agent_start, agent_goal,
                                eps=1e-10):
    """LSC normal for linear predictions (TrajPlanner::normalVector,
    traj_planner.cpp:1869-1892) with its zero-distance heuristic.

    Returns (normal (..., 3), closest_dist (...,)).
    """
    c1, c2, dist = closest_between_linear_paths(obs_start, obs_goal,
                                                agent_start, agent_goal)
    delta = c2 - c1
    nrm = jnp.linalg.norm(delta, axis=-1, keepdims=True)
    normal = delta / jnp.maximum(nrm, eps)
    # heuristic when the paths touch: n = (b - a) x z_hat
    a = agent_start - obs_start
    b = agent_goal - obs_goal
    z_hat = jnp.zeros_like(a).at[..., 2].set(1.0)
    alt = jnp.cross(b - a, z_hat)
    alt_n = jnp.linalg.norm(alt, axis=-1, keepdims=True)
    x_hat = jnp.zeros_like(a).at[..., 0].set(1.0)
    alt = jnp.where(alt_n > eps, alt / jnp.maximum(alt_n, eps), x_hat)
    normal = jnp.where(nrm > eps, normal, alt)
    return normal, dist


def ellipsoidal_distance(p1, p2, downwash):
    """Downwash-aware inter-agent distance: z compressed by 1/downwash
    (reference util.hpp:225-229 distBetweenAgents via coordinate transform
    util.hpp:231-240)."""
    delta = p1 - p2
    dz = delta[..., 2] / downwash
    return jnp.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2 + dz ** 2)


def downwash_transform(points, downwash):
    """Scale z by 1/downwash: the coordinate transform applied to control
    points before LSC normal computation (util.hpp:231-240,
    traj_planner.cpp:1347-1349).  points (..., 3), downwash broadcastable."""
    scale = jnp.stack([jnp.ones_like(downwash), jnp.ones_like(downwash),
                       1.0 / downwash], axis=-1)
    return points * scale


def pair_downwash(radius_i, downwash_i, radius_j, downwash_j):
    """Combined downwash coefficient for an agent pair
    (traj_planner.cpp:1339-1345)."""
    return ((downwash_i * radius_i + downwash_j * radius_j)
            / (radius_i + radius_j))


def point_box_distance(point, box_min, box_max):
    """Distance from point to an axis-aligned box (0 inside)."""
    d = jnp.maximum(box_min - point, 0.0) + jnp.maximum(point - box_max, 0.0)
    return jnp.linalg.norm(d, axis=-1)


def collision_time_linear(obs_start, obs_goal, agent_start, agent_goal,
                          collision_dist, horizon, eps=1e-12):
    """First time in [0, horizon] when two linearly-moving points get closer
    than collision_dist; +inf if never (reference computeCollisionTime,
    geometry.hpp:553-642, linear-path case).

    Relative motion r(t) = r0 + (t/T)(r1 - r0); solve ||r(t)|| = R.
    """
    r0 = agent_start - obs_start
    r1 = agent_goal - obs_goal
    d = r1 - r0
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(r0 * d, axis=-1)
    c = jnp.sum(r0 * r0, axis=-1) - collision_dist ** 2
    inf = jnp.full_like(a, jnp.inf)
    # already colliding at t=0
    t_hit0 = jnp.where(c <= 0, 0.0, jnp.inf)
    disc = b * b - 4 * a * c
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    s1 = (-b - sqrt_disc) / jnp.maximum(2 * a, eps)
    valid = (disc >= 0) & (a > eps) & (s1 >= 0.0) & (s1 <= 1.0)
    t_hit = jnp.where(valid, s1 * horizon, inf)
    return jnp.minimum(t_hit0, t_hit)


def closest_between_segments(a0, a1, b0, b1, eps=1e-12):
    """Closest points between two segments [a0,a1] and [b0,b1], batched.

    Reference closestPointsBetweenLineSegments (geometry.hpp:172-235)
    enumerates endpoint/interior candidates; here the standard clamped
    parametric solution (identical minimum).  Returns
    (closest_a (...,3), closest_b (...,3), dist (...,)).
    """
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    A = jnp.sum(d1 * d1, axis=-1)
    e = jnp.sum(d2 * d2, axis=-1)
    f = jnp.sum(d2 * r, axis=-1)
    c = jnp.sum(d1 * r, axis=-1)
    b = jnp.sum(d1 * d2, axis=-1)
    denom = A * e - b * b
    # interior candidate (lines not parallel), else s = 0
    s = jnp.where(denom > eps, (b * f - c * e) /
                  jnp.where(denom > eps, denom, 1.0), 0.0)
    s = jnp.clip(s, 0.0, 1.0)
    # t from s, then re-clamp s from t (Ericson's robust two-pass clamp)
    t = jnp.where(e > eps, (b * s + f) / jnp.where(e > eps, e, 1.0), 0.0)
    t_cl = jnp.clip(t, 0.0, 1.0)
    s = jnp.where(A > eps, (b * t_cl - c) / jnp.where(A > eps, A, 1.0), 0.0)
    s = jnp.clip(s, 0.0, 1.0)
    pa = a0 + d1 * s[..., None]
    pb = b0 + d2 * t_cl[..., None]
    return pa, pb, jnp.linalg.norm(pa - pb, axis=-1)


def segment_box_distance(start, goal, box_min, box_max, iters: int = 48,
                         eps=1e-12):
    """Min distance between segment [start, goal] and an AABB, batched.

    The point-to-box distance along a line is convex in the parameter,
    so a fixed-iteration ternary search is exact to tolerance -- the
    branch-free batched replacement for the reference's edge-enumeration
    closestPointsBetweenLineSegmentAndStaticObs (geometry.hpp:398-436).
    """
    lo = jnp.zeros(start.shape[:-1], start.dtype)
    hi = jnp.ones_like(lo)

    def dist_at(t):
        p = start + (goal - start) * t[..., None]
        return point_box_distance(p, box_min, box_max)

    for _ in range(iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        take_lo = dist_at(m1) <= dist_at(m2)
        hi = jnp.where(take_lo, m2, hi)
        lo = jnp.where(take_lo, lo, m1)
    return dist_at(0.5 * (lo + hi))


def segment_box_collision(start, goal, box_min, box_max, radius,
                          eps=1e-12):
    """Swept-sphere vs AABB: does the radius-sphere moving along
    [start, goal] hit the box?  (checkCollisionBetweenLineSegmentAndBox,
    geometry.hpp:497-551: slab test on the radius-inflated box, then the
    exact segment-box distance check that trims the inflated corners.)
    Returns (...,) bool."""
    big_min = box_min - radius[..., None]
    big_max = box_max + radius[..., None]
    d = goal - start
    moving = jnp.abs(d) > eps
    t1 = (big_min - start) / jnp.where(moving, d, 1.0)
    t2 = (big_max - start) / jnp.where(moving, d, 1.0)
    t_lo = jnp.where(moving, jnp.minimum(t1, t2), -jnp.inf)
    t_hi = jnp.where(moving, jnp.maximum(t1, t2), jnp.inf)
    inside_static = (start >= big_min) & (start <= big_max)
    ok_static = jnp.where(moving, True, inside_static)
    a_min = jnp.maximum(jnp.max(t_lo, axis=-1), 0.0)
    a_max = jnp.minimum(jnp.min(t_hi, axis=-1), 1.0)
    slab_hit = (a_min <= a_max) & jnp.all(ok_static, axis=-1)
    exact = segment_box_distance(start, goal, box_min, box_max) < radius
    return slab_hit & exact


def box_collision_time(start, goal, box_min, box_max, radius, horizon,
                       eps=1e-12):
    """First time in [0, horizon] the radius-sphere moving along
    [start, goal] reaches an AABB; +inf if never (computeCollisionTime
    static-obstacle overload, geometry.hpp:598-642: slab entry time on
    the inflated box, then the sphere collision time against the box
    closest point at entry)."""
    big_min = box_min - radius[..., None]
    big_max = box_max + radius[..., None]
    d = goal - start
    moving = jnp.abs(d) > eps
    t1 = (big_min - start) / jnp.where(moving, d, 1.0)
    t2 = (big_max - start) / jnp.where(moving, d, 1.0)
    t_lo = jnp.where(moving, jnp.minimum(t1, t2), -jnp.inf)
    t_hi = jnp.where(moving, jnp.maximum(t1, t2), jnp.inf)
    inside_static = (start >= big_min) & (start <= big_max)
    ok_static = jnp.where(moving, True, inside_static)
    a_min = jnp.maximum(jnp.max(t_lo, axis=-1), 0.0)
    a_max = jnp.minimum(jnp.min(t_hi, axis=-1), 1.0)
    miss = (a_min > a_max) | ~jnp.all(ok_static, axis=-1)

    entry = start + d * a_min[..., None]
    obs_pt = jnp.clip(entry, box_min, box_max)   # box closest point
    t = collision_time_linear(obs_pt, obs_pt, start, goal, radius,
                              horizon)
    return jnp.where(miss, jnp.inf, t)


def safe_dist_in_direction(position, direction, obs_pos, obs_radius,
                           radius, boxes=None, eps=1e-12):
    """How far `position` can advance along unit `direction` before any
    obstacle's safety sphere / box is reached (safeDistInDirection,
    geometry.hpp:651-708).

    position/direction: (..., 3); obs_pos: (..., O, 3);
    obs_radius: (..., O); radius: (...,); boxes: (B, 6) or None.
    Returns (...,) >= 0, +inf when the ray is clear.
    """
    rel = obs_pos - position[..., None, :]
    proj = jnp.sum(rel * direction[..., None, :], axis=-1)   # (..., O)
    perp2 = jnp.sum(rel * rel, axis=-1) - proj * proj
    r_sum = obs_radius + radius[..., None]
    hit = (perp2 < r_sum * r_sum) & (proj > 0)
    back = jnp.sqrt(jnp.maximum(r_sum * r_sum - perp2, 0.0))
    cand = jnp.where(hit, jnp.maximum(proj - back, 0.0), jnp.inf)
    # a sphere already overlapping the position blocks immediately
    overlap = jnp.sum(rel * rel, axis=-1) < r_sum * r_sum
    cand = jnp.where(overlap, 0.0, cand)
    safe = jnp.min(cand, axis=-1) if cand.shape[-1] else \
        jnp.full(position.shape[:-1], jnp.inf)
    if boxes is not None and boxes.shape[0]:
        # reference: fake 10 m ray through box_collision_time
        fake = 10.0
        goal = position + direction * fake
        t = box_collision_time(position[..., None, :],
                               goal[..., None, :],
                               boxes[..., :3], boxes[..., 3:],
                               radius[..., None], 1.0)
        safe = jnp.minimum(safe, jnp.min(fake * t, axis=-1))
    return safe

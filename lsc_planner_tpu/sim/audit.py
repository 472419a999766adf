"""On-line safety audit + metrics, batched on device.

Reference: MultiSyncSimulator::savePlanningResult
(src/multi_sync_simulator.cpp:408-511) -- every cycle, sample all agent
trajectories at the record time step and compute the pairwise ellipsoidal
(downwash-aware) safety ratios; ratio < 1 is a collision.  This is the
de-facto integration test of the reference (SURVEY.md section 4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bernstein as bz
from ..runtime import exact_f32


def _sample_times(record_time_step: float, time_step: float,
                  inclusive: bool) -> np.ndarray:
    ts = [0.0]
    t = record_time_step
    while t < time_step - 1e-6:
        ts.append(t)
        t += record_time_step
    if inclusive:
        ts.append(time_step)
    return np.asarray(ts)


def _sample_weight_matrix(ts, dt, M, n) -> np.ndarray:
    """Precomputed Bernstein sample weights W (T, M, n+1): position at
    time ts[t] of a piecewise curve with segment time dt is
    einsum('mi,mid->d', W[t], ctrl).  Pure numpy (ts and dt are static
    per config), so sampling costs ONE einsum instead of a traced
    segment-lookup + basis evaluation per time point."""
    from ..ops.bernstein import nchoosek
    ts = np.asarray(ts, np.float64)
    W = np.zeros((len(ts), M, n + 1))
    binom = np.asarray([nchoosek(n, k) for k in range(n + 1)], np.float64)
    for t_i, t in enumerate(ts):
        m = min(max(int(np.floor(t / dt)), 0), M - 1)
        tau = t / dt - m
        i = np.arange(n + 1)
        W[t_i, m] = binom * tau ** i * (1.0 - tau) ** (n - i)
    return W


def positions_at(trajs, ts, dt):
    """Sample positions of all agents at times ts: (T, N, 3).

    The explicit precision=HIGHEST stays although the cycle entry points
    trace under the full-f32 policy (runtime.exact_f32): this function is
    also called outside them, by `precision_self_check`.  A reduced-
    precision einsum (bf16 passes on the previous chip, TF32 on the H100)
    quantizes sampled positions at |x| ~ 148 m and collapses nearby
    agents onto identical points -- the audit then reports phantom
    collisions (min ratio 0.0) on perfectly safe trajectories.  The
    audit is the de-facto integration test
    (multi_sync_simulator.cpp:446-503); it must be exact in f32.
    """
    M, n1 = trajs.shape[-3], trajs.shape[-2]
    W = jnp.asarray(_sample_weight_matrix(ts, dt, M, n1 - 1), trajs.dtype)
    return jnp.einsum("tmi,nmid->tnd", W, trajs,
                      precision=jax.lax.Precision.HIGHEST)


def pairwise_safety_ratio(pos, radius, downwash):
    """Min over pairs of ellipsoidal_distance / (r_i + r_j).

    pos: (..., N, 3); radius/downwash: (N,).  The pair downwash mixes both
    agents' coefficients (multi_sync_simulator.cpp:459-464).
    """
    N = pos.shape[-2]
    r_sum = radius[:, None] + radius[None, :]
    dw = (downwash[:, None] * radius[:, None] +
          downwash[None, :] * radius[None, :]) / r_sum
    delta = pos[..., :, None, :] - pos[..., None, :, :]
    dist = jnp.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2 +
                    (delta[..., 2] / dw) ** 2)
    ratio = dist / r_sum
    eye = jnp.eye(N, dtype=bool)
    ratio = jnp.where(eye, jnp.inf, ratio)
    return jnp.min(ratio, axis=(-2, -1))


def step_safety_ratio(trajs, radius, downwash, dt, record_time_step,
                      time_step):
    """Min safety ratio over the record samples of the upcoming step."""
    ts = _sample_times(record_time_step, time_step, inclusive=False)
    pos = positions_at(trajs, ts, dt)           # (T, N, 3)
    return jnp.min(pairwise_safety_ratio(pos, radius, downwash))


def obstacle_safety_ratio(pos, obs_pos, radius, obs_radius):
    """Agent-vs-dynamic-obstacle safety (multi_sync_simulator.cpp:480-499),
    plain euclidean.  pos: (N, 3), obs_pos: (O, 3)."""
    delta = pos[:, None, :] - obs_pos[None, :, :]
    dist = jnp.linalg.norm(delta, axis=-1)
    return jnp.min(dist / (radius[:, None] + obs_radius[None, :]))


def static_box_safety_ratio(pos, boxes, radius):
    """Agent-vs-static-AABB safety: exact analytic box distance over
    agent radius.  The reference audits obstacles by center distance
    over summed radii (multi_sync_simulator.cpp:480-499) -- for a
    `static` box whose msg radius is -1 that formula is meaningless
    (obstacle.hpp:473), so the box closest-point form
    (obstacle.hpp:437-478 / geometry.hpp:237-362) is used instead.

    pos: (N, 3); boxes: (B, 6) [min, max]; radius: (N,).
    """
    lo, hi = boxes[:, :3], boxes[:, 3:]
    q = jnp.maximum(jnp.maximum(lo[None] - pos[:, None],
                                pos[:, None] - hi[None]), 0.0)
    dist = jnp.linalg.norm(q, axis=-1)                  # (N, B)
    return jnp.min(dist / radius[:, None])


def continuous_safety_ratio(trajs, radius, downwash):
    """Continuous-time pairwise safety ratio over the whole horizon.

    Strengthens the reference's sampled audit
    (multi_sync_simulator.cpp:446-503 samples at record_time_step) to an
    exact-in-time check: for every agent pair and segment, the minimum of
    the downwash-scaled relative Bernstein curve's norm is found by root
    isolation on <delta, delta'> (distanceBetweenPolys,
    polynomial.hpp:310-413), so no inter-sample near-miss can hide.

    trajs: (N, M, n+1, 3).  Returns scalar min over pairs/segments/time of
    ellipsoidal_distance / (r_i + r_j).
    """
    N = trajs.shape[0]
    r_sum = radius[:, None] + radius[None, :]
    dw = (downwash[:, None] * radius[:, None] +
          downwash[None, :] * radius[None, :]) / r_sum        # (N, N)
    rel = trajs[:, None] - trajs[None, :]          # (N, N, M, n+1, 3)
    scale = jnp.stack([jnp.ones_like(dw), jnp.ones_like(dw), 1.0 / dw],
                      axis=-1)                     # (N, N, 3)
    rel = rel * scale[:, :, None, None, :]
    dist, _ = bz.curve_pair_min_distance(rel, jnp.zeros_like(rel))
    ratio = dist / r_sum[..., None]                # (N, N, M)
    eye = jnp.eye(N, dtype=bool)[..., None]
    return jnp.min(jnp.where(eye, jnp.inf, ratio))


def precision_self_check(coord: float = 148.0, sep: float = 0.43,
                         tol: float = 1e-3) -> dict:
    """Assert that position sampling is exact f32 on the default backend.

    Round-4 regression (found on the previous chip): the audit einsum at
    default matmul precision rounded f32 positions through bf16 (~0.5 m
    quantum at |x| ~ 148 m), collapsing agents 0.43 m apart onto
    identical sampled points and reporting phantom min_safety = 0.0 on
    provably safe trajectories (true f64 safety 1.197).  On the H100 the
    same leak would be TF32 (~7 cm quantum).  The pytest suite is
    CPU-pinned and cannot see this, so the bench and chip_smoke.py call
    this on the device.

    Builds a two-agent trajectory pair at +/-(coord) with separation
    ``sep`` along x and checks two paths against the f64 numpy
    recompute:
      * ``audit_sampling_m``: `positions_at` (the audit);
      * ``rollout_m``: the Bernstein flat-output rollout
        (``bernstein.traj_state``, used by `SyncSimulator.propagate` and
        `inject_positions`) jitted under the cycle's precision policy
        (`runtime.exact_f32`), at mid-segment times so the basis mixes
        control points.
    Returns the max abs error of each in metres; raises AssertionError
    when either exceeds ``tol``.
    """
    M, n1, dt = 5, 6, 0.2
    base = np.zeros((2, M, n1, 3), np.float64)
    base[0, ..., 0] = coord
    base[1, ..., 0] = coord + sep
    base[:, ..., 1] = -coord
    base[:, ..., 2] = 1.5
    # mild curvature so the einsum actually mixes control points
    ramp = np.linspace(0.0, 0.1, M * n1).reshape(M, n1)
    base[..., 0] += ramp
    traj32 = jnp.asarray(base, jnp.float32)

    def max_err(dev, ts):
        W = _sample_weight_matrix(ts, dt, M, n1 - 1)
        ref = np.einsum("tmi,nmid->tnd", W, base)
        return float(np.abs(np.asarray(dev) - ref).max())

    ts = _sample_times(0.05, 0.2, inclusive=False)
    ts_roll = np.asarray([0.07, 0.31, 0.55, 0.93])
    rollout = jax.jit(exact_f32(lambda tr: jax.vmap(
        lambda t: jax.vmap(lambda x: bz.traj_state(x, t, dt)["pos"])(tr))(
            jnp.asarray(ts_roll, tr.dtype))))
    errs = {"audit_sampling_m": max_err(positions_at(traj32, ts, dt), ts),
            "rollout_m": max_err(rollout(traj32), ts_roll)}
    for name, err in errs.items():
        if not err < tol:
            raise AssertionError(
                f"{name} error {err:.4f} m > {tol} on backend "
                f"{jax.devices()[0].platform}: position sampling is not exact "
                "f32 (reduced-precision matmul); min_safety values are "
                "untrustworthy")
    return errs


def step_distance(trajs, dt, record_time_step, time_step):
    """Total swarm path length accumulated over the upcoming step, sampled
    at the record resolution (getTotalDistance,
    multi_sync_simulator.cpp:671-680)."""
    ts = _sample_times(record_time_step, time_step, inclusive=True)
    pos = positions_at(trajs, ts, dt)           # (T+1, N, 3)
    seg = jnp.linalg.norm(jnp.diff(pos, axis=0), axis=-1)
    return jnp.sum(seg)

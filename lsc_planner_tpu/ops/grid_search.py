"""Batched grid path planning: wavefront sweep + LOS sub-goal selection.

Replaces the vendored Astar-3D package + GridBasedPlanner
(src/grid_based_planner.cpp, src/Astar-3D/*).  The reference's A* is
6-connected unit-cost (EnvironmentOptions defaults: allowdiagonal=FALSE,
environmentoptions.cpp:13-20) with a euclidean heuristic -- its optimal
paths are exactly the geodesics of a 6-neighbour wavefront distance field,
which maps to a batched iterative min-plus stencil over (N, X, Y, Z)
batched across all agents; the sequential open-list disappears entirely.

Also covers: grid occupancy from the ESDF + higher-priority-agent
ellipsoids (updateGridMap, grid_based_planner.cpp:92-195), occupied-start
recovery (:197-245), greedy-descent path extraction (lppath analog), and
findLOSFreeGoal with the shrinking-margin ray casts (:350-433).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Param, SP_EPSILON, SP_EPSILON_FLOAT
from ..missions import Mission

_INF = jnp.inf


@dataclasses.dataclass
class GridPlanner:
    mission: Mission
    param: Param
    esdf: object                   # world.esdf.ESDF
    dtype: object = jnp.float32
    max_wavefront_iters: Optional[int] = None
    max_path_len: Optional[int] = None
    ray_samples: int = 64

    def __post_init__(self):
        p = self.param
        gres = p.grid_resolution
        wmin = np.asarray(self.mission.world_min, np.float64)
        wmax = np.asarray(self.mission.world_max, np.float64)
        # updateGridInfo (grid_based_planner.cpp:70-90): grid snapped
        # toward zero from the world bbox
        self.grid_min = -np.floor((-wmin + SP_EPSILON) / gres) * gres
        self.grid_max = np.floor((wmax + SP_EPSILON) / gres) * gres
        if p.world_dimension == 2:
            self.grid_min[2] = p.world_z_2d
            self.grid_max[2] = p.world_z_2d
        self.dims = np.round(
            (self.grid_max - self.grid_min) / gres).astype(int) + 1
        X, Y, Z = self.dims
        if self.max_wavefront_iters is None:
            self.max_wavefront_iters = int(1.5 * (X + Y + Z))
        if self.max_path_len is None:
            self.max_path_len = int(X + Y + Z)

        # metric coordinates of every grid point
        ii, jj, kk = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                                 indexing="ij")
        pts = (self.grid_min[None, None, None, :] +
               np.stack([ii, jj, kk], axis=-1) * gres)
        self._grid_pts = jnp.asarray(pts, self.dtype)      # (X, Y, Z, 3)

        # static occupancy per distinct agent radius (updateGridMap
        # :110-123: occupied iff esdf < radius + grid_margin)
        self._static_occ = {}
        if self.esdf is not None:
            radii = sorted({round(float(a.radius), 6)
                            for a in self.mission.agents})
            for r in radii:
                d = self.esdf.at_points(self._grid_pts)
                self._static_occ[r] = d < (r + p.grid_margin)

    def static_occupancy(self, radius: float):
        r = round(float(radius), 6)
        if not self._static_occ:
            return jnp.zeros(tuple(self.dims), bool)
        return self._static_occ[r]

    # ------------------------------------------------------------------
    def occupancy(self, radius, downwash, obs_pos, obs_radius,
                  obs_downwash, higher_mask):
        """Per-agent grids with higher-priority agents as ellipsoid
        obstacles (updateGridMap, grid_based_planner.cpp:162-189).

        radius/downwash: (N,); obs_*: (O,); higher_mask: (N, O) bool.
        Returns occ (N, X, Y, Z) bool.
        """
        N = radius.shape[0]
        base = self.static_occupancy(float(self.mission.agents[0].radius))
        occ0 = jnp.broadcast_to(base[None], (N,) + tuple(self.dims))

        # ellipsoid test: sqrt(dxy^2 + (dz/downwash_total)^2) < r_i + r_j;
        # scanned over the obstacle axis to keep memory at (N, X, Y, Z)
        dw_tot = ((radius[:, None] * downwash[:, None] +
                   obs_radius[None, :] * obs_downwash[None, :]) /
                  (radius[:, None] + obs_radius[None, :]))     # (N, O)
        r_sum = radius[:, None] + obs_radius[None, :]          # (N, O)
        grid = self._grid_pts                                  # (X,Y,Z,3)

        def add_obstacle(occ, inputs):
            opos, dw_o, rs_o, hp_o = inputs   # (3,), (N,), (N,), (N,)
            delta = grid[None] - opos                          # (1,X,Y,Z,3)
            d = jnp.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2 +
                         (delta[..., 2] /
                          dw_o[:, None, None, None]) ** 2)
            inside = d < rs_o[:, None, None, None]
            occ = occ | (inside & hp_o[:, None, None, None])
            return occ, None

        occ, _ = jax.lax.scan(
            add_obstacle, occ0,
            (obs_pos, dw_tot.T, r_sum.T, higher_mask.T))
        return occ

    # ------------------------------------------------------------------
    def to_cell(self, point):
        gres = self.param.grid_resolution
        gmin = jnp.asarray(self.grid_min, point.dtype)
        return jnp.round((point - gmin) / gres).astype(jnp.int32)

    def to_point(self, cell):
        gres = self.param.grid_resolution
        gmin = jnp.asarray(self.grid_min, self.dtype)
        return gmin + cell.astype(self.dtype) * gres

    def recover_start(self, occ, start_cell):
        """Occupied-start recovery (updateGridMission,
        grid_based_planner.cpp:209-233): nearest free cell in a 5x5 x/y
        neighbourhood (z fixed for 3-D: k in [-1, 1] per the reference's
        `2 - dim .. dim - 1` range with dim=3 -> k in {-1, 0, 1}), by
        manhattan distance; ties by scan order.  occ: (X,Y,Z) bool."""
        p = self.param
        kr = range(2 - p.world_dimension, p.world_dimension - 1)
        offsets = [(i, j, k) for i in range(-2, 3) for j in range(-2, 3)
                   for k in kr]
        dims = jnp.asarray(self.dims, jnp.int32)
        best = start_cell
        best_d = jnp.asarray(10 ** 9, jnp.int32)
        for (i, j, k) in offsets:
            cand = start_cell + jnp.asarray([i, j, k], jnp.int32)
            ok = jnp.all(cand >= 0) & jnp.all(cand < dims)
            cc = jnp.clip(cand, 0, dims - 1)
            free = ok & ~occ[cc[0], cc[1], cc[2]]
            d = abs(i) + abs(j) + abs(k)
            better = free & (d < best_d)
            best = jnp.where(better, cand, best)
            best_d = jnp.where(better, d, best_d)
        occupied0 = occ[start_cell[0], start_cell[1], start_cell[2]]
        return jnp.where(occupied0, best, start_cell)

    def wavefront(self, occ, goal_cell):
        """6-connected unit-cost distance-to-goal field.

        occ: (..., X, Y, Z) bool; goal_cell: (..., 3).  Returns D with
        jnp.inf where unreachable.  The goal cell is treated as free
        (matching A* which plans to it regardless once popped)."""
        X, Y, Z = self.dims
        big = jnp.asarray(np.inf, self.dtype)
        ii = jnp.arange(X)[:, None, None]
        jj = jnp.arange(Y)[None, :, None]
        kk = jnp.arange(Z)[None, None, :]
        is_goal = ((ii == goal_cell[..., None, None, None, 0]) &
                   (jj == goal_cell[..., None, None, None, 1]) &
                   (kk == goal_cell[..., None, None, None, 2]))
        D0 = jnp.where(is_goal, 0.0, big)
        blocked = occ & ~is_goal

        def step(D, _):
            best = D
            for axis, shift in ((0, 1), (0, -1), (1, 1), (1, -1),
                                (2, 1), (2, -1)):
                ax = D.ndim - 3 + axis
                rolled = jnp.roll(D, shift, axis=ax)
                # mask the wrapped border slice
                idx = [slice(None)] * D.ndim
                idx[ax] = 0 if shift == 1 else -1
                rolled = rolled.at[tuple(idx)].set(big)
                best = jnp.minimum(best, rolled + 1.0)
            return jnp.where(blocked, big, best), None

        D, _ = jax.lax.scan(step, D0, None,
                            length=self.max_wavefront_iters)
        return D

    def descend_path(self, D, start_cell):
        """Greedy descent of the distance field from the start cell: the
        wavefront analog of lppath (makePrimaryPath).  Returns metric
        points (P, 3) with the tail clamped to the reached cell."""
        dims = jnp.asarray(self.dims, jnp.int32)
        nbrs = jnp.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                            [0, 0, 1], [0, 0, -1]], jnp.int32)

        def step(cell, _):
            cand = cell[None, :] + nbrs                     # (6, 3)
            ok = jnp.all(cand >= 0, axis=1) & jnp.all(cand < dims, axis=1)
            cc = jnp.clip(cand, 0, dims - 1)
            vals = D[cc[:, 0], cc[:, 1], cc[:, 2]]
            vals = jnp.where(ok, vals, jnp.inf)
            here = D[cell[0], cell[1], cell[2]]
            best = jnp.argmin(vals)
            move = vals[best] < here
            nxt = jnp.where(move, cc[best], cell)
            return nxt, nxt

        _, cells = jax.lax.scan(step, start_cell, None,
                                length=self.max_path_len)
        cells = jnp.concatenate([start_cell[None], cells], axis=0)
        return self.to_point(cells)

    # ------------------------------------------------------------------
    def cast_ray(self, a, b, clearance_radius):
        """Discretized swept-sphere check along [a, b] against the ESDF
        (castRay, grid_based_planner.cpp:409-433: recursive bisection; here
        a fixed fine sampling at <= resolution/2 spacing).  a, b: (..., 3);
        returns (...,) bool."""
        p = self.param
        t = jnp.linspace(0.0, 1.0, self.ray_samples).astype(a.dtype)
        pts = a[..., None, :] + (b - a)[..., None, :] * t[..., :, None]
        d = self.esdf.at_points(pts)
        thr = clearance_radius[..., None] + 0.5 * p.world_resolution \
            - SP_EPSILON_FLOAT
        return jnp.all(d > thr, axis=-1)

    def _ray_safe_sampled(self, pts, init_end, radius, ratios):
        """Sampled sphere-cover admissibility for all (agent, ratio, path
        point) rays.  Returns (N, 6, P) bool.

        No origin-clearance relaxation here: lowering the threshold to
        the agent's own (sub-margin) clearance admits rays through gaps
        NARROWER than the agent's body -- the sub-goal then points
        through a wall the QP can never pass, and the agent oscillates
        against it forever (observed on multi_square16 + simple_forest).
        Pocket escape is handled by the path-floor in los_free_goal
        instead."""
        t = jnp.linspace(0.0, 1.0, self.ray_samples).astype(pts.dtype)
        ray = init_end[:, None, None, :] + \
            (pts - init_end[:, None, :])[:, :, None, :] * t[None, None, :,
                                                            None]
        min_clear = jnp.min(self.esdf.at_points(ray), axis=-1)  # (N, P)
        thr = (radius[:, None] * ratios[None, :] +
               0.5 * self.param.world_resolution - SP_EPSILON_FLOAT)
        return min_clear[:, None, :] > thr[:, :, None]          # (N, 6, P)

    @property
    def castray_depth(self) -> int:
        """Dyadic recursion depth for the exact castRay DP: deep enough
        that any all-clear segment resolves by the sphere-cover test
        (d_l < 2 sqrt(margin * resolution) given endpoint clearance
        > margin + resolution/2), so the fixed-depth cutoff can never
        fire on a ray the reference recursion would accept."""
        p = self.param
        diag = float(np.linalg.norm(self.grid_max - self.grid_min)) + 1e-6
        r_min = min(float(a.radius) for a in self.mission.agents)
        d_resolve = 2.0 * np.sqrt(max(r_min * p.world_resolution, 1e-6))
        return max(1, min(10, int(np.ceil(np.log2(diag / d_resolve)))))

    def _ray_safe_bisect(self, pts, init_end, radius, ratios):
        """Exact castRay recursion (grid_based_planner.cpp:409-433) as a
        bottom-up DP over dyadic segments: a level-l segment is safe iff
        its endpoints clear margin + resolution/2 AND (the sphere-cover
        test sqrt(d_l^2/4 + margin^2) < min(1, endpoint clearances)
        passes OR both level-(l+1) halves are safe).  Returns (N, 6, P)
        bool."""
        p = self.param
        depth = self.castray_depth
        S = 2 ** depth + 1
        t = jnp.linspace(0.0, 1.0, S).astype(pts.dtype)
        ray = init_end[:, None, None, :] + \
            (pts - init_end[:, None, :])[:, :, None, :] * t[None, None, :,
                                                            None]
        c = self.esdf.at_points(ray)                        # (N, P, S)
        length = jnp.linalg.norm(pts - init_end[:, None, :], axis=-1)
        margin = radius[:, None] * ratios[None, :]          # (N, 6)
        res_thr = 0.5 * p.world_resolution - SP_EPSILON_FLOAT
        max_dist = 1.0                                      # castRay TODO

        safe = None
        for level in range(depth, -1, -1):
            stride = 2 ** (depth - level)
            cl = c[:, :, ::stride]                          # (N,P,2^l+1)
            left = cl[:, :, :-1][:, :, None, :]             # (N,P,1,2^l)
            right = cl[:, :, 1:][:, :, None, :]
            m = margin[:, None, :, None]                    # (N,1,6,1)
            d_l = (length / (2 ** level))[:, :, None, None]
            thr = jnp.sqrt(0.25 * d_l * d_l + m * m)
            eok = (left > m + res_thr) & (right > m + res_thr)
            cover = (thr < max_dist) & (left > thr) & (right > thr)
            if safe is None:
                safe_l = eok & cover
            else:
                child = safe[..., 0::2] & safe[..., 1::2]
                safe_l = eok & (cover | child)
            safe = safe_l
        return jnp.swapaxes(safe[..., 0], 1, 2)             # (N, 6, P)

    def los_free_goal(self, path_points, init_end, desired_goal, radius):
        """findLOSFreeGoal (grid_based_planner.cpp:350-407): walk the path
        in order, keep the furthest point with line of sight from the
        initial-trajectory endpoint; retry with shrinking margin ratios
        1.5 -> 1.0 until the sub-goal moves > 0.3 m.

        path_points: (N, P, 3); init_end/desired_goal: (N, 3);
        radius: (N,).  Returns (N, 3).
        """
        N = path_points.shape[0]
        pts = jnp.concatenate([path_points, desired_goal[:, None]], axis=1)
        P = pts.shape[1]
        ratios = jnp.asarray([1.5, 1.4, 1.3, 1.2, 1.1, 1.0], self.dtype)

        if self.param.grid_los_exact_castray:
            safe = self._ray_safe_bisect(pts, init_end, radius, ratios)
        else:
            safe = self._ray_safe_sampled(pts, init_end, radius, ratios)
        prefix_safe = jnp.cumprod(safe, axis=-1).astype(bool)
        n_safe = jnp.sum(prefix_safe, axis=-1)              # (N, 6)
        last_idx = jnp.maximum(n_safe - 1, 0)
        los = jnp.take_along_axis(
            pts[:, None].repeat(6, 1), last_idx[..., None, None].repeat(3, -1),
            axis=2)[:, :, 0, :]                             # (N, 6, 3)
        any_safe = n_safe > 0
        los = jnp.where(any_safe[..., None], los,
                        init_end[:, None, :])
        moved = jnp.linalg.norm(los - init_end[:, None, :],
                                axis=-1) > 0.3              # (N, 6)
        # first ratio with moved=True, else the last ratio
        first = jnp.argmax(moved, axis=1)
        any_moved = jnp.any(moved, axis=1)
        first = jnp.where(any_moved, first, 5)
        sel = jnp.take_along_axis(
            los, first[:, None, None].repeat(3, -1), axis=1)[:, 0, :]
        if self.param.grid_los_exact_castray:
            # strict reference semantics: LOS shortcuts only
            return sel
        # Path-floor (robustness extension beyond the reference, which
        # freezes in EDT-discretization pockets -- README.md:70-75): when
        # no LOS ray admits real progress AND the grid path offers a
        # farther steering point than the degenerate LOS selection,
        # steer toward the first few path cells.  Path cells carry
        # >= radius + grid_margin clearance by construction and
        # consecutive cells are adjacent, so following them is how a
        # wedged agent backs out of / climbs over a pocket; actual
        # safety is still enforced by the SFC constraints in the QP.
        # The farther-than-sel condition keeps the healthy endgame
        # intact: within 0.3 m of the goal nothing "moves", but the LOS
        # selection IS the goal and must not be floored to the agent's
        # own cell.
        floor_pt = pts[:, min(2, P - 1), :]
        sel_d = jnp.linalg.norm(sel - init_end, axis=-1)
        floor_d = jnp.linalg.norm(floor_pt - init_end, axis=-1)
        prefer_floor = (~any_moved) & (floor_d > sel_d)
        return jnp.where(prefer_floor[:, None], floor_pt, sel)

    # ------------------------------------------------------------------
    def plan_goals(self, pos, init_end, desired_goal, radius, downwash,
                   obs_pos, obs_radius, obs_downwash, higher_mask):
        """Full prior-based grid pipeline for all agents: occupancy ->
        wavefront (with priority obstacles; static-only fallback when no
        path, traj_planner.cpp:594-599) -> descent path -> LOS goal.

        Returns (los_goal (N, 3), path_floor (N, 3)).  path_floor is the
        grid-path point ~2 cells along -- consecutive path cells are
        axis-adjacent free cells with >= radius + grid_margin clearance,
        so steering to it is always coverable by an axis-aligned SFC
        expansion; the deadlock rescue uses it as its first escape
        candidate when the LOS sub-goal points through a gap the
        corridor cannot reach (blind rotations can wedge the agent
        against a second obstacle instead)."""
        N = pos.shape[0]
        occ_hp = self.occupancy(radius, downwash, obs_pos, obs_radius,
                                obs_downwash, higher_mask)
        occ_st = jnp.broadcast_to(
            self.static_occupancy(float(self.mission.agents[0].radius))[
                None], occ_hp.shape)

        start = jax.vmap(self.to_cell)(pos)
        goal = jax.vmap(self.to_cell)(desired_goal)
        start = jax.vmap(self.recover_start)(occ_hp, start)

        D_hp = jax.vmap(self.wavefront)(occ_hp, goal)
        D_st = jax.vmap(self.wavefront)(occ_st, goal)
        reachable = jax.vmap(
            lambda D, c: D[c[0], c[1], c[2]] < jnp.inf)(D_hp, start)
        D = jnp.where(reachable[:, None, None, None], D_hp, D_st)

        path = jax.vmap(self.descend_path)(D, start)        # (N, P, 3)
        los = self.los_free_goal(path, init_end, desired_goal, radius)
        floor = path[:, min(2, path.shape[1] - 1), :]
        return los, floor

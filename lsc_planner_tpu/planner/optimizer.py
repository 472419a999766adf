"""Trajectory-QP assembly: batched min-jerk Bernstein optimization.

Re-designs the reference TrajOptimizer (``src/traj_optimizer.cpp``) as a
batched tensor program:

 * The reference keeps all M*(n+1)*dim control points as CPLEX variables and
   adds phi + (M-1)*phi equality rows per dimension (buildAeqBase,
   traj_optimizer.cpp:186-236).  Here the equalities (initial-state pin +
   C^{phi-1} continuity + the LSC stop-at-horizon rows,
   traj_optimizer.cpp:529-536) are eliminated analytically at setup:
   x = F y + G s0, shrinking the per-agent KKT system from 90+45 to ~39
   variables and guaranteeing the equalities exactly.
 * Cost (buildQBase:169-184 + terminal goal tracking :354-372) and all
   inequality rows (world bounds :274-303, LSC/SFC :407-466, dynamic
   feasibility :469-525) are assembled as fixed-shape batched tensors with
   row masks, then handed to the batched interior-point solver in
   ``ops/qp.py``.

Per-agent problems are identical in structure, so one jit covers the whole
swarm; everything static (F, G, Q, row templates) is float64 numpy computed
once per Param.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Param, PlannerMode, SP_EPSILON
from ..ops import bernstein as bz
from ..ops import qp as qp_ops


class PlaneConstraints(NamedTuple):
    """Unified half-space rows applied per control point.

    normal: (N, C, M, 3)     rows  n . x_{m,i} >= rhs_{m,i}
    rhs:    (N, C, M, n+1)
    mask:   (N, C, M)        constraint-active mask (i-skip applied inside)
    LSC rows use C = number of obstacles; SFC box faces are appended as 6
    extra pseudo-obstacles whose normals are +-e_k.
    """
    normal: jnp.ndarray
    rhs: jnp.ndarray
    mask: jnp.ndarray


class QPResult(NamedTuple):
    traj: jnp.ndarray        # (N, M, n+1, 3)
    cost: jnp.ndarray        # (N,)
    primal_res: jnp.ndarray  # (N,) max constraint violation of the solution
    gap: jnp.ndarray         # (N,) complementarity
    y: jnp.ndarray           # (N, nv) raw solution (warm-start handle)
    slack: Optional[jnp.ndarray] = None   # (N, S) slack variables (<= 0)
    warm_res: Optional[jnp.ndarray] = None  # (N,) warm-start violation
    warm_row: Optional[jnp.ndarray] = None  # (N,) argmax row
    lam: Optional[jnp.ndarray] = None       # (N, nr) inequality duals
    iters: Optional[jnp.ndarray] = None     # IPM iterations consumed


class SlackSpec(NamedTuple):
    """Slack-variable relaxation (traj_optimizer.cpp:306-326, :374-390).

    mode 'collision': one slack per (constraint entry c < n_slack_c,
    segment m), added to that obstacle's LSC rows; `enable` (N, C) marks
    which constraint entries actually get slack (SlackMode.COLLISION or
    the disturbance obs_slack_indices).
    mode 'dynamical': 2M slacks relaxing velocity (m) / acceleration (M+m)
    limits for every agent.
    """
    mode: str
    enable: Optional[jnp.ndarray] = None     # (N, C) for 'collision'
    n_slack_c: int = 0                       # for 'collision'
    weight: float = 100000.0


def _build_equality_basis(M: int, n: int, phi: int, dt: float,
                          stop_at_horizon: bool):
    """Return (F, G, free_cols) with x_dim = F @ y_dim + G @ [p0, v0, a0].

    x_dim layout: index (m, i) -> m*(n+1)+i, matching the reference variable
    order (traj_optimizer.cpp:72-74).  Equality rows follow buildAeqBase
    (traj_optimizer.cpp:186-236); derivation notes: the i-th start/end
    derivative of segment m is dt^{-i} * n!/(n-i)! * (forward/backward
    difference of order i), which pins c[m][0..phi-1] given the previous
    segment (or the initial state for m=0).
    """
    nv = M * (n + 1)

    def col(m, i):
        return m * (n + 1) + i

    # difference matrices A_0 (start) and A_T (end): row j = j-th order
    # forward/backward difference coefficients (traj_optimizer.cpp:190-203
    # hard-codes these for n=5; we generate them for any n).
    A0 = np.zeros((phi, n + 1))
    AT = np.zeros((phi, n + 1))
    for j in range(phi):
        for t in range(j + 1):
            A0[j, t] = (-1.0) ** (j - t) * bz.nchoosek(j, t)
            AT[j, n - t] = (-1.0) ** t * bz.nchoosek(j, t)

    n_eq = phi + (M - 1) * phi
    E = np.zeros((n_eq, nv))
    # initial-state rows: dt^{-j} * fallfac(n, j) * A0 . c^0 = d_j
    for j in range(phi):
        fall = 1.0
        for t in range(j):
            fall *= (n - t)
        E[j, col(0, 0):col(0, n + 1)] = dt ** (-j) * fall * A0[j]
    # continuity rows between segment m-1 and m
    for m in range(1, M):
        for j in range(phi):
            fall = 1.0
            for t in range(j):
                fall *= (n - t)
            r = phi + (m - 1) * phi + j
            E[r, col(m - 1, 0):col(m - 1, n + 1)] = dt ** (-j) * fall * AT[j]
            E[r, col(m, 0):col(m, n + 1)] = -(dt ** (-j)) * fall * A0[j]

    det_cols = [col(m, i) for m in range(M) for i in range(phi)]
    free_cols = [col(m, i) for m in range(M) for i in range(phi, n + 1)]
    Edd = E[:, det_cols]
    Edf = E[:, free_cols]
    Edd_inv = np.linalg.inv(Edd)

    nf = len(free_cols)
    F = np.zeros((nv, nf))
    G = np.zeros((nv, phi))
    F[det_cols, :] = -Edd_inv @ Edf
    for k, c in enumerate(free_cols):
        F[c, k] = 1.0
    # deq = [p0, v0, a0, 0, ...] (buildDeq, traj_optimizer.cpp:239-259)
    G[det_cols, :] = Edd_inv[:, :phi]

    if stop_at_horizon:
        # LSC stop-at-horizon rows (traj_optimizer.cpp:529-536):
        # c[M-1][n] == c[M-1][n-i] for i = 1..phi-1, i.e. the last phi
        # endpoint control points of the final segment coincide.  For
        # n >= 2*phi - 1 (n=5, phi=3 included) the tied set lies entirely
        # inside the free vars, so the reduction is a column merge.
        n_free_seg = n + 1 - phi
        keep = nf - n_free_seg            # free vars of segments 0..M-2
        n_untied = n + 1 - 2 * phi        # free vars below the tied set
        if n_untied < 0:
            raise NotImplementedError("stop-at-horizon needs n >= 2*phi-1")
        nf_red = keep + n_untied + 1
        R = np.zeros((nf, nf_red))
        for k in range(keep + n_untied):
            R[k, k] = 1.0
        for k in range(keep + n_untied, nf):
            R[k, nf_red - 1] = 1.0
        F = F @ R

    return F, G, free_cols


@dataclasses.dataclass
class TrajOptimizer:
    """Static QP structure for a given Param (built once, jit-friendly)."""
    param: Param

    @cached_property
    def M(self):
        return self.param.M

    @cached_property
    def n(self):
        return self.param.n

    @cached_property
    def dim(self):
        """QP dimensions: 2-D worlds drop the z variable block entirely
        (the reference treats world_dimension == 2 first-class -- every
        `if (dim == 3)` in traj_optimizer.cpp:261-539 skips z).  The z
        trajectory is the equality particular solution G @ (z0, vz0,
        az0) with zero free part -- an exact constant hold for the
        steady 2-D state (z0 = z_2d, vz0 = az0 = 0) -- and plane rows
        keep their full 3-D right-hand side while contributing only
        in-plane coefficients, exactly as the reference's 2-D rows do.
        Cuts the KKT system from (3 nf)^2 to (2 nf)^2: ~2.2x per solve.
        """
        return 2 if self.param.world_dimension == 2 else 3

    @cached_property
    def _FG(self):
        stop = self.param.planner_mode == PlannerMode.LSC
        return _build_equality_basis(self.M, self.n, self.param.phi,
                                     self.param.dt, stop)

    @property
    def F(self) -> np.ndarray:
        return self._FG[0]

    @property
    def G(self) -> np.ndarray:
        return self._FG[1]

    @cached_property
    def nf(self) -> int:
        return self.F.shape[1]

    @cached_property
    def nv(self) -> int:
        return self.dim * self.nf

    @cached_property
    def Q_full(self) -> np.ndarray:
        """Block-diagonal per-segment jerk Gram, (M(n+1), M(n+1))."""
        Qb = bz.q_base(self.n, self.param.phi, self.param.phi_n,
                       self.param.dt)
        return np.kron(np.eye(self.M), Qb)

    @cached_property
    def FQF(self) -> np.ndarray:
        return self.F.T @ self.Q_full @ self.F

    @cached_property
    def FQ(self) -> np.ndarray:
        return self.F.T @ self.Q_full        # (nf, nv_x)

    @cached_property
    def endpoint_rows(self) -> np.ndarray:
        """U[m] = F[(m, n), :] -- y-space row of each segment endpoint."""
        idx = [m * (self.n + 1) + self.n for m in range(self.M)]
        return self.F[idx, :]                # (M, nf)

    @cached_property
    def G_endpoint(self) -> np.ndarray:
        idx = [m * (self.n + 1) + self.n for m in range(self.M)]
        return self.G[idx, :]                # (M, phi)

    @cached_property
    def F_seg(self) -> np.ndarray:
        return self.F.reshape(self.M, self.n + 1, self.nf)

    @cached_property
    def y_extract_idx(self) -> np.ndarray:
        """x-space indices whose values reproduce y: for each reduced free
        variable, the (m, i) control point it directly parameterizes
        (used to warm-start the QP from the shifted previous solution,
        which is feasible by the LSC construction).

        The candidate rows MUST be restricted to the free x-columns:
        C^2 continuity gives the determined point c[m][2] a coefficient
        of exactly +1.0 on the free variable c[m-1][3]
        (c[m][2] = 4 c[m-1][5] - 4 c[m-1][4] + c[m-1][3]), so scanning
        all x-rows for F[:, k] == 1 silently picks that wrong row and
        extracts y values ~0.15 m off the true free control points --
        making every warm start infeasible by that much."""
        free = np.asarray(self._FG[2])
        idx = []
        for k in range(self.nf):
            rows = np.nonzero(np.abs(self.F[free, k] - 1.0) < 1e-12)[0]
            # the stop-at-horizon tied column has three free rows; the
            # endpoint (last) carries the group's value
            idx.append(int(free[rows[-1]]))
        return np.asarray(idx)

    def extract_y(self, traj):
        """Map trajectories (N, M, n+1, 3) to warm-start vectors (N, nv).
        Exact when traj lies on the equality manifold (prev-solution
        shifts); approximate otherwise (still a useful IPM start).
        In 2-D mode only the x/y blocks are extracted."""
        N = traj.shape[0]
        x = traj.transpose(0, 3, 1, 2)[:, :self.dim].reshape(
            N, self.dim, self.M * (self.n + 1))
        y = x[:, :, self.y_extract_idx]
        return y.reshape(N, self.nv)

    @cached_property
    def G_seg(self) -> np.ndarray:
        return self.G.reshape(self.M, self.n + 1, 3)

    # ------------------------------------------------------------------
    # static inequality row templates in x-space (per dimension)
    # ------------------------------------------------------------------
    @cached_property
    def static_rows(self):
        """(A_x (R, dim, nvx), kind_info) for world bounds + dynamics.

        kind rows reference: bounds traj_optimizer.cpp:274-303 (variable
        bounds), velocity :472-491, acceleration :494-523.  b is assembled
        per agent at trace time from (world_min/max, max_vel, max_acc).
        """
        M, n, phi, dim = self.M, self.n, self.param.phi, self.dim
        dt = self.param.dt
        nvx = M * (n + 1)

        rows = []          # (coeff row (dim, nvx), kind, k, sign)
        def col(m, i):
            return m * (n + 1) + i

        # world bounds: +-x_{k,m,i}, skip m=0 & i<phi
        for k in range(dim):
            for m in range(M):
                for i in range(n + 1):
                    if m == 0 and i < phi:
                        continue
                    a = np.zeros((dim, nvx))
                    a[k, col(m, i)] = 1.0
                    rows.append((a, "lb", k, m))
                    rows.append((-a, "ub", k, m))

        # velocity rows: +-(n/dt)(c_{i+1} - c_i) <= vmax, skip m=0,i<2
        for k in range(dim):
            for m in range(M):
                for i in range(n):
                    if m == 0 and i in (0, 1):
                        continue
                    a = np.zeros((dim, nvx))
                    a[k, col(m, i + 1)] = n / dt
                    a[k, col(m, i)] = -n / dt
                    rows.append((-a, "vel", k, m))
                    rows.append((a, "vel", k, m))

        # acceleration rows, skip m=0,i=0
        for k in range(dim):
            for m in range(M):
                for i in range(n - 1):
                    if m == 0 and i == 0:
                        continue
                    a = np.zeros((dim, nvx))
                    c2 = n * (n - 1) / dt ** 2
                    a[k, col(m, i + 2)] = c2
                    a[k, col(m, i + 1)] = -2 * c2
                    a[k, col(m, i)] = c2
                    rows.append((-a, "acc", k, m))
                    rows.append((a, "acc", k, m))

        A_x = np.stack([r[0] for r in rows])        # (R, dim, nvx)
        kinds = [(r[1], r[2], r[3]) for r in rows]
        return A_x, kinds

    @cached_property
    def A_static_y(self) -> np.ndarray:
        """Static rows mapped to y-space, (R_s, nv)."""
        A_x, _ = self.static_rows
        Ay = np.einsum("rkp,pf->rkf", A_x, self.F)
        return Ay.reshape(A_x.shape[0], self.nv)

    @cached_property
    def static_blocked(self):
        """Structured form of the static rows for the factored QP path.

        Every static row (bound/velocity/acceleration) acts on exactly one
        dimension block of nf variables, and rows come in adjacent +- pairs
        sharing a row vector -- so A_st^T diag(d) A_st is block-diagonal
        and needs only (3, Ru, nf) unique rows with paired d, a ~18x FLOP
        cut over the dense (R_s, nv) Gram that dominated the IPM iteration
        at production swarm sizes.

        Returns (U (3, Ru, nf), row_perm (R_s,), inv_row_perm (R_s,)):
        U[k, u] is the +row of pair u in dim k; row_perm groups the
        original row order dim-major with pairs adjacent (+ then -).
        """
        A = self.A_static_y
        nf = self.nf
        R_s = A.shape[0]
        # dim of each row from the row-template kinds (rows between
        # stop-at-horizon-tied control points are identically zero in
        # y-space, so the dim cannot be recovered from the matrix)
        _, kinds = self.static_rows
        dim_of = np.asarray([k for _kind, k, _m in kinds])
        assert np.all(dim_of[0::2] == dim_of[1::2]), "pairs span dims"
        assert all(np.allclose(A[2 * p], -A[2 * p + 1])
                   for p in range(R_s // 2)), "rows are not +- pairs"
        pair_perm = np.argsort(dim_of[0::2], kind="stable")
        row_perm = np.empty(R_s, np.int64)
        row_perm[0::2] = 2 * pair_perm
        row_perm[1::2] = 2 * pair_perm + 1
        inv_row_perm = np.argsort(row_perm)
        counts = np.bincount(dim_of[0::2], minlength=self.dim)
        assert np.all(counts == counts[0]), "unequal rows per dim"
        Ru = int(counts[0])
        U = np.zeros((self.dim, Ru, nf))
        for k in range(self.dim):
            rows = 2 * pair_perm[k * Ru:(k + 1) * Ru]
            U[k] = A[rows][:, k * nf:(k + 1) * nf]
        return U, row_perm, inv_row_perm

    @cached_property
    def _static_b_index(self):
        """(kind_id (R_s,), k_idx (R_s,)) row-selection indices for the
        vectorized static_b; kind_id: 0=lb 1=ub 2=vel 3=acc."""
        _, kinds = self.static_rows
        kind_id = np.asarray([{"lb": 0, "ub": 1, "vel": 2, "acc": 3}[kd]
                              for kd, _k, _m in kinds], np.int32)
        k_idx = np.asarray([k for _kd, k, _m in kinds], np.int32)
        return kind_id, k_idx

    def static_b(self, world_min, world_max, max_vel, max_acc, gx):
        """Per-agent rhs for the static rows.

        gx: (N, dim, nvx) = G @ s0 contribution per dimension.
        Returns (N, R_s).  Row values are gathered with precomputed
        index arrays (one `take` per limit source) rather than a
        per-row Python loop: the loop form traced ~4 ops per static
        row (~1.8k HLO ops per cycle at R_s=414) and dominated the
        small-swarm dispatch overhead.
        """
        A_x, _ = self.static_rows
        A_xj = jnp.asarray(A_x, dtype=gx.dtype)
        kind_id, k_idx = self._static_b_index
        kind_id = jnp.asarray(kind_id)
        k_idx = jnp.asarray(k_idx)
        bound_r = jnp.where(kind_id == 0, world_min[k_idx],
                            -world_max[k_idx])          # (R_s,)
        limit_r = jnp.where((kind_id == 2)[None, :], -max_vel[:, k_idx],
                            -max_acc[:, k_idx])         # (N, R_s)
        b0 = jnp.where((kind_id < 2)[None, :], bound_r[None, :], limit_r)
        corr = jnp.einsum("rkp,nkp->nr", A_xj, gx)
        return b0 - corr

    # ------------------------------------------------------------------
    # per-cycle assembly + solve
    # ------------------------------------------------------------------
    def solve(self, pos, vel, acc, current_goal, nominal_velocity,
              max_vel, max_acc, planes: PlaneConstraints,
              world_min, world_max, y_warm: Optional[jnp.ndarray] = None,
              slack: Optional[SlackSpec] = None,
              dtype=jnp.float32) -> QPResult:
        """Assemble and solve the swarm QP.

        pos/vel/acc/current_goal: (N, 3); max_vel/max_acc: (N, 3);
        planes: LSC+SFC half-space rows.  Returns batched trajectories.
        Contractions run at the caller's matmul precision: the cycle
        entry points trace this under full f32 (runtime.exact_f32).
        """
        return self._solve_impl(pos, vel, acc, current_goal,
                                nominal_velocity, max_vel, max_acc,
                                planes, world_min, world_max, y_warm,
                                slack, dtype)

    def _slack_layout(self, slack: SlackSpec, n_rows_static: int,
                      C: int, dtype):
        """Static per-row slack-column indices (-1 = none)."""
        M, n = self.M, self.n
        if slack.mode == "collision":
            S = slack.n_slack_c * M
            col_static = np.full(n_rows_static, -1)
            cmi = np.full((C, M, n + 1), -1)
            for c in range(min(slack.n_slack_c, C)):
                for m in range(M):
                    cmi[c, m, :] = c * M + m
            col_planes = cmi.reshape(-1)
            m_of = np.tile(np.arange(M), slack.n_slack_c)
        else:   # dynamical
            S = 2 * M
            _, kinds = self.static_rows
            col_static = np.asarray(
                [m if kind == "vel" else (M + m if kind == "acc" else -1)
                 for kind, _k, m in kinds])
            col_planes = np.full(C * M * (n + 1), -1)
            m_of = np.concatenate([np.arange(M), np.arange(M)])
        col = np.concatenate([col_static, col_planes])
        weights = 2.0 * slack.weight * (self.M - m_of) / self.M
        return S, jnp.asarray(col), jnp.asarray(weights, dtype)

    def _solve_impl(self, pos, vel, acc, current_goal, nominal_velocity,
                    max_vel, max_acc, planes, world_min, world_max,
                    y_warm, slack, dtype):
        p = self.param
        N = pos.shape[0]
        M, n, phi, dim = self.M, self.n, p.phi, self.dim
        nf, nv = self.nf, self.nv

        F = jnp.asarray(self.F, dtype)
        FQF = jnp.asarray(self.FQF, dtype)
        FQ = jnp.asarray(self.FQ, dtype)
        U = jnp.asarray(self.endpoint_rows, dtype)      # (M, nf)
        G = jnp.asarray(self.G, dtype)                  # (nvx, 3)
        F_seg = jnp.asarray(self.F_seg, dtype)          # (M, n+1, nf)

        # per-dim init vector [p0_k, v0_k, a0_k]; gx3 keeps ALL 3 dims
        # (the z particular solution is the whole z trajectory in 2-D
        # mode and the plane-row rhs needs it), gx only the QP dims
        s0 = jnp.stack([pos, vel, acc], axis=1)         # (N, phi, 3)
        s0 = jnp.swapaxes(s0, 1, 2)                     # (N, 3, phi)
        gx3 = jnp.einsum("pj,nkj->nkp", G, s0)          # (N, 3, nvx)
        g_seg3 = gx3.reshape(N, 3, M, n + 1)
        gx = gx3[:, :dim]
        g_seg = g_seg3[:, :dim]

        # --- terminal weight mask (getTerminalSegments,
        #     traj_optimizer.cpp:541-548) ---
        dist_to_goal = jnp.linalg.norm(current_goal - pos, axis=-1)
        ideal_time = dist_to_goal / jnp.maximum(nominal_velocity, 1e-6)
        T = jnp.maximum(
            jnp.floor((M * p.dt - ideal_time + SP_EPSILON) / p.dt), 1.0)
        T = jnp.clip(T, 1.0, M).astype(jnp.int32)       # (N,)
        m_idx = jnp.arange(M)
        tmask = (m_idx[None, :] >= (M - T)[:, None]).astype(dtype)  # (N, M)

        # --- cost: P (N, dim, nf, nf) block-diag, q (N, dim, nf) ---
        w_ci = p.control_input_weight
        w_t = self._terminal_weight(dist_to_goal, dtype)       # (N,)
        P_ci = 2.0 * w_ci * FQF                               # (nf, nf)
        P_term = 2.0 * w_t[:, None, None] * \
            jnp.einsum("nm,mf,mg->nfg", tmask, U, U)
        P_dimblk = P_ci[None, None] + P_term[:, None]          # (N,1,nf,nf)
        P_dimblk = jnp.broadcast_to(P_dimblk, (N, dim, nf, nf))

        g_end = g_seg[..., :, n]                               # (N, dim, M)
        q_ci = 2.0 * w_ci * jnp.einsum("fp,nkp->nkf", FQ, gx)
        q_term = 2.0 * w_t[:, None, None] * jnp.einsum(
            "nm,mf,nkm->nkf", tmask, U,
            g_end - current_goal[:, :dim, None])
        q = (q_ci + q_term).reshape(N, nv)

        # expand block-diagonal P to (N, nv, nv)
        P = jnp.zeros((N, nv, nv), dtype)
        for k in range(dim):
            P = P.at[:, k * nf:(k + 1) * nf, k * nf:(k + 1) * nf].set(
                P_dimblk[:, k])

        # --- plane (LSC/SFC) rows ---
        # the rhs correction uses the FULL 3-D particular solution (in
        # 2-D mode the z part -- a held constant -- folds the n_z * z
        # term into b, matching the reference's 2-D rows); the row
        # coefficients then carry only the QP dims
        normal3, rhs, cmask = planes.normal, planes.rhs, planes.mask
        C = normal3.shape[1]
        b_pl4 = rhs.astype(dtype) - jnp.einsum(
            "ncmk,nkmi->ncmi", normal3.astype(dtype), g_seg3)  # (N,C,M,n+1)
        normal = normal3[..., :dim]
        i_idx = jnp.arange(n + 1)
        iskip = (m_idx[:, None] > 0) | (i_idx[None, :] >= phi)  # (M, n+1)
        ncs_mask = m_idx < p.n_constraint_segments               # (M,)
        mask_pl4 = (cmask[..., None] & iskip[None, None] &
                    ncs_mask[None, None, :, None])               # 4-D

        # --- static rows ---
        b_st = self.static_b(jnp.asarray(world_min, dtype),
                             jnp.asarray(world_max, dtype),
                             max_vel.astype(dtype), max_acc.astype(dtype),
                             gx)

        # Row-representation dispatch (static shapes, decided at trace
        # time): the factored form wins once the dense (N, C*M*(n+1), nv)
        # row tensor is memory-bandwidth-bound (~180 MB at 1024 agents x
        # 32 neighbours, streamed twice per IPM iteration); below that
        # one big matmul beats many small contractions.  The 48 MB
        # threshold was set on the previous chip and has not been
        # measured on the H100 yet.  Slack modes always use dense rows.
        dense_bytes = N * C * M * (n + 1) * nv * np.dtype(dtype).itemsize
        if slack is None and dense_bytes > 48 * 2 ** 20:
            sol = qp_ops.solve_qp_lsc(
                P, q, self.A_static_y, b_st, normal.astype(dtype), b_pl4,
                mask_pl4, F_seg, y0=y_warm, iters=p.qp_iterations,
                tol_gap=p.qp_tol_gap, tol_rp=p.qp_tol_rp,
                tol_rd=p.qp_tol_rd, tol_step=p.qp_tol_step,
                correctors=p.qp_correctors,
                s_min=p.qp_s_min,
                static_blocks=self.static_blocked)
            return self._recover(sol, N, dtype, None, None, tmask,
                                 current_goal, gx3)

        # dense rows
        A_pl = jnp.einsum("ncmk,mif->ncmikf", normal.astype(dtype), F_seg)
        A_pl = A_pl.reshape(N, C * M * (n + 1), nv)
        b_pl = b_pl4.reshape(N, C * M * (n + 1))
        mask_pl = mask_pl4.reshape(N, C * M * (n + 1))

        A_st = jnp.broadcast_to(jnp.asarray(self.A_static_y, dtype)[None],
                                (N,) + self.A_static_y.shape)
        mask_st = jnp.ones(b_st.shape, dtype=bool)

        A = jnp.concatenate([A_st, A_pl], axis=1)
        b = jnp.concatenate([b_st, b_pl], axis=1)
        mask = jnp.concatenate([mask_st, mask_pl], axis=1)

        # --- optional slack-variable extension ---
        slack_vals = None
        slack_wts = None
        if slack is not None:
            R_static = A_st.shape[1]
            R = A.shape[1]
            S, col, slack_wts = self._slack_layout(slack, R_static, C,
                                                   dtype)
            onehot = jax.nn.one_hot(col, S, dtype=dtype)       # (R, S)
            if slack.mode == "collision":
                c_of_row = jnp.concatenate([
                    jnp.full((R_static,), -1, jnp.int32),
                    jnp.repeat(jnp.arange(C, dtype=jnp.int32),
                               M * (n + 1))])
                en = jnp.where(c_of_row[None, :] >= 0,
                               jnp.take_along_axis(
                                   slack.enable.astype(dtype),
                                   jnp.clip(c_of_row, 0)[None, :].repeat(
                                       N, 0), axis=1),
                               0.0)                            # (N, R)
                A_sl = -onehot[None] * en[..., None]
            else:
                A_sl = jnp.broadcast_to(-onehot[None], (N, R, S))
            eyeS = jnp.eye(S, dtype=dtype)
            bound_rows = jnp.concatenate(
                [jnp.zeros((N, S, nv), dtype),
                 jnp.broadcast_to(-eyeS[None], (N, S, S))], axis=2)
            A = jnp.concatenate(
                [jnp.concatenate([A, A_sl], axis=2), bound_rows], axis=1)
            b = jnp.concatenate([b, jnp.zeros((N, S), dtype)], axis=1)
            mask = jnp.concatenate([mask, jnp.ones((N, S), bool)], axis=1)
            P_ext = jnp.zeros((N, nv + S, nv + S), dtype)
            P_ext = P_ext.at[:, :nv, :nv].set(P)
            P_ext = P_ext.at[:, nv:, nv:].set(
                jnp.diag(slack_wts)[None, :, :])
            P = P_ext
            q = jnp.concatenate([q, jnp.zeros((N, S), dtype)], axis=1)
            if y_warm is not None:
                y_warm = jnp.concatenate(
                    [y_warm, jnp.zeros((N, S), dtype)], axis=1)

        sol = qp_ops.solve_qp(P, q, A, b, mask=mask, y0=y_warm,
                              iters=p.qp_iterations, s_min=p.qp_s_min,
                              correctors=p.qp_correctors)

        slack_vals = sol.y[:, nv:] if slack is not None else None
        return self._recover(sol, N, dtype, slack_vals, slack_wts, tmask,
                             current_goal, gx3)

    def _terminal_weight(self, dist_to_goal, dtype):
        """Per-agent terminal weight (N,).

        mode "simple": the constant `terminal_weight` the reference
        ships (traj_optimizer.cpp:353-355).  mode "distance": the
        reference authors' clamped distance-scaled variant
        min(w / dist, 10) (traj_optimizer.cpp:345-352, left commented
        out there).  The default is "distance": with the shipped
        constant weight the endgame is a weakly-damped oscillator (the
        jerk Gram outweighs the goal pull ~1e4:1, so plans coast
        through the goal and park ~0.2 m beyond -- a ring attractor
        that strands f32 runs short of the all-agents-at-goal finish
        condition); scaling the pull up near the goal critically damps
        the final approach while leaving en-route behavior identical."""
        p = self.param
        if p.terminal_weight_mode == "distance":
            # clamped BELOW at the shipped constant -- w/dist alone
            # (the reference's literal variant) DROPS below w beyond
            # 1 m and visibly slows en-route progress (forest missions
            # stopped finishing); the floor keeps everything except the
            # final approach identical to "simple" mode
            w = jnp.clip(
                p.terminal_weight / jnp.maximum(dist_to_goal, 1e-3),
                p.terminal_weight, 10.0 * p.terminal_weight)
            return w.astype(dtype)
        return jnp.full(dist_to_goal.shape, p.terminal_weight, dtype)

    def _recover(self, sol, N, dtype, slack_vals, slack_wts, tmask,
                 current_goal, gx3):
        """Map the QP solution back to control points and the CPLEX-parity
        objective value (shared by the dense and factored paths).
        gx3 (N, 3, nvx): in 2-D mode its z row IS the output z trajectory
        (held particular solution; zero free part)."""
        M, n, dim = self.M, self.n, self.dim
        nf, nv = self.nf, self.nv
        w_ci = self.param.control_input_weight
        F = jnp.asarray(self.F, dtype)

        y_sol = sol.y[:, :nv]
        y_dims = y_sol.reshape(N, dim, nf)
        x = jnp.einsum("pf,nkf->nkp", F, y_dims) + gx3[:, :dim]
        if dim < 3:
            # z hold: free z control points pinned at z0 (= gx3's
            # determined (0,0) entry), so the z trajectory is the
            # smooth equality-manifold continuation to hover at z0 --
            # exactly constant for the steady 2-D state
            z0 = gx3[:, 2, 0]                               # (N,)
            Fs = jnp.sum(F, axis=1)                         # (nvx,)
            z_row = z0[:, None] * Fs[None, :] + gx3[:, 2]
            x = jnp.concatenate([x, z_row[:, None, :]], axis=1)
        traj = x.reshape(N, 3, M, n + 1).transpose(0, 2, 3, 1)

        # cost in x-space for CPLEX-objective parity (2-D: the held z
        # polynomial is constant for steady states, so its jerk cost is
        # ~0 and the z terminal term is absent -- matching the
        # reference's dim==2 objective)
        Qf = jnp.asarray(self.Q_full, dtype)
        cost_ci = w_ci * jnp.einsum("nkp,pq,nkq->n", x[:, :dim], Qf,
                                    x[:, :dim])
        endpoints = traj[:, :, n, :]                       # (N, M, 3)
        pos0 = traj[:, 0, 0, :]                            # (N, 3)
        w_t = self._terminal_weight(
            jnp.linalg.norm(current_goal - pos0, axis=-1), dtype)
        cost_term = w_t * jnp.einsum(
            "nm,nmk->n", tmask,
            (endpoints[..., :dim] - current_goal[:, None, :dim]) ** 2)
        cost = cost_ci + cost_term
        if slack_vals is not None:
            cost = cost + 0.5 * jnp.einsum("s,ns->n", slack_wts,
                                           slack_vals ** 2)

        return QPResult(traj=traj, cost=cost, primal_res=sol.primal_res,
                        gap=sol.gap, y=y_sol, slack=slack_vals,
                        warm_res=getattr(sol, "warm_res", None),
                        warm_row=getattr(sol, "warm_row", None),
                        lam=sol.lam, iters=getattr(sol, "iters", None))

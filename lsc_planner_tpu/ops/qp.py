"""Batched dense convex QP solver (primal-dual interior point).

Batched replacement for the per-agent CPLEX dual-simplex solve
(reference ``src/traj_optimizer.cpp:31-154``): instead of one 90-variable QP
at a time on 10 CPU threads, we solve the whole swarm's QPs as one batched
tensor program,

    min_y  1/2 y^T P y + q^T y    s.t.  A y >= b          (rows maskable)

with P (N, nv, nv), A (N, nr, nv).  Equality constraints are eliminated
upstream (see planner/optimizer.py), which both shrinks the KKT system and
removes the reference's free-variable special cases.

Method: Mehrotra predictor-corrector with normal-equations elimination;
every iteration forms  H = P + A^T D A  (a batched matmul), takes one
batched Cholesky, and reuses the factor for the predictor and
corrector solves.  Iteration count is static for jit; masked rows are
implemented by zeroing their A rows and giving them a trivially-satisfied
bound so their duals decay to ~0.

Two row representations share one IPM core (``_ipm``):
 * dense rows (``solve_qp``) -- general, used by the slack-relaxation
   modes and the ORCA/tests paths;
 * factored plane rows (``solve_qp_lsc``) -- every LSC/SFC row is the
   Kronecker product  a_{c,m,i} = normal_{c,m} (x) F_seg[m,i,:],  so
   A y, A^T w and A^T D A are computed from the (C, M, 3) normals and the
   static (M, n+1, nf) segment basis directly.  At 1024 agents x 32
   neighbours the dense row tensor alone is ~180 MB and every IPM
   iteration has to stream it twice from device memory; the factored
   form is ~100x smaller and turns the Gram update into a few small
   contractions.

Every contraction here must be full f32: the callers trace it under
``jax.default_matmul_precision("highest")`` (runtime.exact_f32).  A TF32
H = P + A'DA can lose positive-definiteness, and the batched Cholesky
then returns NaNs.

Infeasibility diagnostics (the analog of CPLEX conflict refinement,
traj_optimizer.cpp:104-137) are returned as the per-row violation of the
final iterate; callers report argmax rows.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

# LSC_QP_DEBUG=1: per-iteration exit-signal trace from _ipm
_QP_DEBUG = bool(os.environ.get("LSC_QP_DEBUG"))
# LSC_QP_TRACE=1: eager per-iteration trace (Python loop instead of
# while_loop, for backends without debug callbacks).  Diagnostic only --
# do not jit the caller.
_QP_TRACE = bool(os.environ.get("LSC_QP_TRACE"))


class QPSolution(NamedTuple):
    y: jnp.ndarray          # (..., nv) primal solution
    lam: jnp.ndarray        # (..., nr) dual solution
    obj: jnp.ndarray        # (...,)   0.5 y'Py + q'y
    primal_res: jnp.ndarray  # (...,)  max_i max(b_i - a_i'y, 0)
    gap: jnp.ndarray        # (...,)   complementarity mu
    warm_res: jnp.ndarray = None   # (...,) warm-start max violation
    warm_row: jnp.ndarray = None   # (...,) argmax row of the above
    iters: jnp.ndarray = None      # () or (...,) IPM iterations consumed
                                   # (observability: proves whether the
                                   # early exit fired or the cap governed)


def _masked(A, b, mask):
    """Zero out masked rows and make their bound trivially satisfied."""
    if mask is None:
        return A, b
    m = mask[..., None]
    return jnp.where(m, A, 0.0), jnp.where(mask, b, -1.0)


def _equilibrate_rows(A, b, floor: float = 1e-3, bmax: float = 1e3):
    """Unit-norm row equilibration with degeneracy guards.

    Rows whose coefficient norm is below `floor` constrain combinations
    the free variables barely influence (e.g. velocity/acceleration
    entries dominated by the pinned initial state); dividing them by
    their ~1e-5 norms creates slacks ~1e6 that dominate the Mehrotra
    complementarity mean and stall the whole solve (mu collapses while
    the primal iterate is still far from optimal -- the round-3
    endgame-hover mechanism, reproducible even in f64).  Such rows are
    dropped as inert (the reference skips initial-state-determined rows
    outright, traj_optimizer.cpp:274-303).  Surviving rows' scaled
    bounds are additionally capped at `bmax` so no single far-from-active
    row distorts the centering statistics."""
    row_norm = jnp.sqrt(jnp.sum(A * A, axis=-1))
    dead = row_norm < floor
    scale = 1.0 / jnp.maximum(row_norm, floor)
    scale = jnp.minimum(scale, bmax / jnp.maximum(jnp.abs(b), 1.0))
    A = jnp.where(dead[..., None], 0.0, A * scale[..., None])
    b = jnp.where(dead, -1.0, b * scale)
    return A, b


def _objective_sigma(P):
    """Per-instance objective scale sigma = mean |diag P| (~1e4-1e5 for
    the raw jerk Gram).

    Used ONLY to make the early-exit tolerances scale-invariant: the
    complementarity gap and the dual residual are compared against
    tol * sigma, so `tol` reads as a RELATIVE tolerance on the O(1)
    normalized objective while the solve itself runs on the raw problem.
    (Round 3 instead rescaled P, q by 1/sigma before solving -- the
    optimum is invariant but the Mehrotra trajectory is NOT: with a warm
    start at the previous optimum and lam0 = 1, the scaled problem's
    duals must SHRINK toward their O(1e-4) optima, mu collapses ahead of
    the iterate, and a capped solve returns a visibly staler point than
    the raw problem's -- the round-3 endgame-stall regression, measured
    as finish vs no-finish at 12 iterations even in f64.)"""
    diag = jnp.einsum("...vv->...v", P)
    return jnp.maximum(jnp.mean(jnp.abs(diag), axis=-1), 1e-6)  # (...,)


def _cholesky(Hs):
    """Batched Cholesky of the (..., nv, nv) normal-equation matrices."""
    return jnp.linalg.cholesky(Hs)


def _chol_solve(L, rhs):
    """Solve (L L^T) x = rhs with batched triangular solves; rhs (..., n)."""
    z = jax.lax.linalg.triangular_solve(L, rhs[..., None], left_side=True,
                                        lower=True)
    x = jax.lax.linalg.triangular_solve(L, z, left_side=True, lower=True,
                                        transpose_a=True)
    return x[..., 0]


def _ipm(P, q, mv, rmv, gram, b, y0, iters, reg, s_min,
         tol_gap: float = 0.0, tol_rp: float = 0.0,
         tol_rd: float = 0.0, tol_scale=None, correctors: int = 0,
         tol_step: float = 0.0):
    """Shared Mehrotra predictor-corrector core.

    mv(y) -> (N, nr) = A y;  rmv(w) -> (N, nv) = A^T w;
    gram(d) -> (N, nv, nv) = A^T diag(d) A.  Rows must arrive
    pre-equilibrated (unit-ish row norms) and pre-masked.

    `iters` is a CAP when tol_gap/tol_rp > 0: the loop exits once EVERY
    instance reaches complementarity gap < tol_gap * sigma (sigma =
    `tol_scale`, the per-instance objective scale from _objective_sigma;
    1 if None) with primal residual < tol_rp AND ABSOLUTE dual residual
    max|Py + q - A'lam| < tol_rd (raw gradient units -- see the exit
    test below for why this one must not be sigma-relative).
    Warm-started steady-state
    cycles converge in well under half the cap; the cap provides
    headroom for congested cycles.

    The dual-residual term is NOT optional: a warm start at the previous
    cycle's optimum is primal-feasible with near-zero slacks on inactive
    rows, so Mehrotra collapses mu in 1-2 iterations while y is still
    the OLD optimum -- mu + r_p alone then exit with the stale point and
    the agent never moves (the round-3 endgame-stall regression).
    CPLEX's barrier exits on the same triple
    (reference src/traj_optimizer.cpp:51-56 uses its defaults).
    """
    dtype = P.dtype
    nv = P.shape[-1]
    tscale = jnp.ones(P.shape[:-2], dtype) if tol_scale is None \
        else tol_scale

    if y0 is None:
        y0 = jnp.zeros(P.shape[:-1], dtype)

    s0 = jnp.maximum(mv(y0) - b, s_min)
    lam0 = jnp.ones_like(s0)
    eye = jnp.eye(nv, dtype=dtype)

    def kkt_rhs(lam, s, r_d, r_p, r_c):
        # (P + A'DA) dy = -r_d - A' [ (r_c + lam*r_p) / s ]
        return -r_d - rmv((r_c + lam * r_p) / s)

    def kkt_finish(dy, lam, s, r_p, r_c):
        ds = mv(dy) + r_p
        dlam = -(r_c + lam * ds) / s
        return dy, ds, dlam

    def step_len(v, dv, tau=0.995):
        # largest alpha in (0, 1] with v + alpha dv >= (1-tau) v
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0),
                          jnp.inf)
        alpha = jnp.min(ratio, axis=-1)
        return jnp.minimum(1.0, tau * alpha)

    def body(carry):
        it, _, done_i, prev_step, y, lam, s = carry
        Ay = mv(y)
        r_d = jnp.einsum("...vw,...w->...v", P, y) + q - rmv(lam)
        r_p = Ay - s - b
        mu = jnp.mean(s * lam, axis=-1)
        # convergence of the CURRENT iterate (checked before stepping so
        # the flag lags one iteration; the while cond consumes it)
        # tol_rd is ABSOLUTE (raw gradient units): the stale-point
        # residual is the goal-pull force ~ 2 w_t dist (O(1)), unrelated
        # to the jerk-Gram scale sigma -- a sigma-relative threshold
        # sits exactly on top of it and freezes agents ~1 m from goal
        # (observed on empty-world corpus missions), while the f32
        # evaluation noise floor of r_d is ~40x below the stale value.
        # At congested swarm scales the f32 cancellation floor of
        # evaluating r_d (~0.4 at sigma |y| ~ 1e7) sits ABOVE tol_rd, so
        # the exit deliberately does not fire there and the iteration
        # cap governs congested cost -- a sound non-exit.  (A
        # step-displacement alternative was measured and rejected: the
        # converged f32 iterate jitters in a ~1-2.5 cm band forever, and
        # accepting that band as "converged" compounds into 30-50 %
        # longer flights in octomap worlds.)
        # Per-instance convergence LATCH: a converged instance freezes
        # instead of riding to the cap -- iterating a warm-started
        # instance past its f32 fixed point degrades it (measured on
        # the previous chip, not re-checked on the H100: centering dies,
        # duals of active rows decay, true dual residual grows to O(100)
        # while complementarity stays perfect).
        if tol_gap > 0.0 and tol_rp > 0.0 and tol_rd > 0.0:
            # stationarity certified by r_d, OR the previous applied
            # step collapsed (the f32 fixed-point detector: the r_d
            # evaluation floor grows with dual magnitudes and an
            # instance that cannot certify r_d degrades if iterated past
            # its fixed point)
            stat = (jnp.max(jnp.abs(r_d), axis=-1) < tol_rd) | \
                (prev_step < tol_step)
            inst_done = ((mu < tol_gap * tscale) &
                         (jnp.max(jnp.abs(r_p), axis=-1) < tol_rp) & stat)
            done_i = done_i | inst_done
            done = jnp.all(done_i)
        else:
            done = jnp.asarray(False)
        if _QP_DEBUG:
            jax.debug.print(
                "it={i} mu_max={m:.2e} gap_tol_max={g:.2e} rp={p:.2e} "
                "rd={d:.2e}", i=it,
                m=jnp.max(mu), g=jnp.max(tol_gap * tscale),
                p=jnp.max(jnp.abs(r_p)), d=jnp.max(jnp.abs(r_d)))

        D = lam / s
        H = P + gram(D)
        # relative ridge: f32 rounding at the ~1e4 scale of the jerk Gram
        # can cost positive-definiteness; an absolute 1e-8 is invisible
        diag_mean = jnp.einsum("...vv->...", H) / nv
        ridge = reg * jnp.maximum(diag_mean, 1.0)
        H = H + ridge[..., None, None] * eye
        # Jacobi equilibration before factorizing: f32 Cholesky at the
        # jerk-Gram's ~1e4 scale with interior-point D spreads loses
        # accuracy without it
        dsc = jax.lax.rsqrt(jnp.einsum("...vv->...v", H))
        Hs = H * dsc[..., :, None] * dsc[..., None, :]

        # predictor (affine scaling)
        r_c_aff = s * lam
        rhs_aff = kkt_rhs(lam, s, r_d, r_p, r_c_aff)
        L = _cholesky(Hs)
        z_aff = _chol_solve(L, dsc * rhs_aff)
        dy_a, ds_a, dlam_a = kkt_finish(dsc * z_aff, lam, s, r_p, r_c_aff)
        a_p = step_len(s, ds_a)
        a_d = step_len(lam, dlam_a)
        mu_aff = jnp.mean((s + a_p[..., None] * ds_a) *
                          (lam + a_d[..., None] * dlam_a), axis=-1)
        sigma = (mu_aff / jnp.maximum(mu, 1e-30)) ** 3

        # corrector
        r_c = s * lam + ds_a * dlam_a - (sigma * mu)[..., None]
        rhs_c = kkt_rhs(lam, s, r_d, r_p, r_c)
        z_c = _chol_solve(L, dsc * rhs_c)
        dy, ds, dlam = kkt_finish(dsc * z_c, lam, s, r_p, r_c)
        a_p = step_len(s, ds)
        a_d = step_len(lam, dlam)

        # Gondzio centrality correctors: re-center OUTLIER
        # complementarity products reusing the SAME factorization.  The
        # LSC row structure replicates each neighbour's plane over
        # ~M(n+1) near-identical rows; their degenerate duals split
        # arbitrarily, a few products collapse toward 0 while others
        # blow past mu, and plain Mehrotra's step lengths stall (the
        # congested-swarm gap plateau, docs/TOLERANCES_r03.md).  Each
        # corrector clips the tentative products into
        # [beta_min mu, beta_max mu] and solves for the compensating
        # direction -- one extra pair of triangular solves per
        # corrector against a full re-factorization per iteration.
        for _ in range(correctors):
            mu_t = sigma * mu                    # target
            s_t = s + a_p[..., None] * ds
            l_t = lam + a_d[..., None] * dlam
            prod = s_t * l_t
            lo = 0.1 * mu_t[..., None]
            hi = 10.0 * mu_t[..., None]
            target = jnp.clip(prod, lo, hi)
            r_cc = r_c + (target - prod)
            rhs_cc = kkt_rhs(lam, s, r_d, r_p, r_cc)
            z_cc = _chol_solve(L, dsc * rhs_cc)
            dy2, ds2, dlam2 = kkt_finish(dsc * z_cc, lam, s, r_p, r_cc)
            a_p2 = step_len(s, ds2)
            a_d2 = step_len(lam, dlam2)
            # accept per instance only where the step lengths improve
            # MATERIALLY (0.05 margin): a knife-edge comparison flips
            # between f32 and f64 on near-ties and makes the truncated
            # solution a discontinuous function of rounding
            better_s = a_p2 + a_d2 > a_p + a_d + 0.05   # (...,)
            better = better_s[..., None]
            dy = jnp.where(better, dy2, dy)
            ds = jnp.where(better, ds2, ds)
            dlam = jnp.where(better, dlam2, dlam)
            r_c = jnp.where(better, r_cc, r_c)
            a_p = jnp.where(better_s, a_p2, a_p)
            a_d = jnp.where(better_s, a_d2, a_d)

        y_n = y + a_p[..., None] * dy
        s_n = jnp.maximum(s + a_p[..., None] * ds, 1e-12)
        lam_n = jnp.maximum(lam + a_d[..., None] * dlam, 1e-12)
        # Degeneracy guard: an agent whose factorization degenerates or
        # whose iterates blow up holds its previous (warm-started,
        # feasible) iterate instead of poisoning the batch.  The growth
        # bound matters for INFEASIBLE instances (the QPFAILED path
        # feeds on primal_res of the returned point): without it the
        # duals race toward the f64 overflow horizon (~1e288 observed on
        # the reference's own conflict dump) before isfinite can fire.
        ok = (jnp.all(jnp.isfinite(y_n), axis=-1) &
              jnp.all(jnp.isfinite(s_n), axis=-1) &
              jnp.all(jnp.isfinite(lam_n), axis=-1) &
              (jnp.max(jnp.abs(y_n), axis=-1) < 1e10) &
              (jnp.max(lam_n, axis=-1) < 1e12))
        ok = ok & jnp.logical_not(done_i)
        step_disp = jnp.where(ok, a_p * jnp.max(jnp.abs(dy), axis=-1),
                              0.0)
        y = jnp.where(ok[..., None], y_n, y)
        s = jnp.where(ok[..., None], s_n, s)
        lam = jnp.where(ok[..., None], lam_n, lam)
        return (it + 1, done, done_i, step_disp, y, lam, s)

    carry = (jnp.zeros((), jnp.int32), jnp.asarray(False),
             jnp.zeros(P.shape[:-2], bool),
             jnp.full(P.shape[:-2], jnp.inf, dtype), y0, lam0, s0)
    if _QP_TRACE:
        import numpy as _np
        for _i in range(iters):
            carry = body(carry)
            _, _, _, _, y_t, lam_t, s_t = carry
            r_d_t = _np.asarray(jnp.einsum("...vw,...w->...v", P, y_t)
                                + q - rmv(lam_t))
            mu_t = _np.asarray(jnp.mean(s_t * lam_t, axis=-1))
            r_p_t = _np.asarray(mv(y_t) - s_t - b)
            rd_pa = _np.max(_np.abs(r_d_t), axis=-1)
            print(f"T it={_i} mu={mu_t.max():.2e} "
                  f"rp={_np.abs(r_p_t).max():.2e} "
                  f"rd={rd_pa.max():.2e} "
                  f"rd_agents={_np.round(rd_pa, 3)}", flush=True)
        it_used, _, _, _, y, lam, s = carry
    else:
        it_used, _, _, _, y, lam, s = jax.lax.while_loop(
            lambda c: jnp.logical_and(c[0] < iters, jnp.logical_not(c[1])),
            body, carry)

    obj = 0.5 * jnp.einsum("...v,...vw,...w->...", y, P, y) + \
        jnp.einsum("...v,...v->...", q, y)
    viol = jnp.maximum(b - mv(y), 0.0)
    primal_res = jnp.max(viol, axis=-1)
    gap = jnp.mean(s * lam, axis=-1)
    return QPSolution(y=y, lam=lam, obj=obj, primal_res=primal_res, gap=gap,
                      iters=it_used)


def solve_qp(P, q, A, b, mask=None, y0=None, iters: int = 20,
             reg: float = 1e-8, s_min: float = 1.0,
             equilibrate: bool = True,
             correctors: int = 0) -> QPSolution:
    """Batched inequality-form QP solve over dense rows; see module
    docstring.

    All arrays share leading batch dims.  `y0` is an optional warm start
    (the LSC-shifted previous solution is feasible by construction, which is
    what makes warm starting effective here).  `s_min` floors the initial
    slacks: starting well-centered (s ~ 1, lam ~ 1) matters more for
    Mehrotra than starting primal-feasible.
    """
    A, b = _masked(A, b, mask)
    if equilibrate:
        A, b = _equilibrate_rows(A, b)

    def mv(y):
        return jnp.einsum("...rv,...v->...r", A, y)

    def rmv(w):
        return jnp.einsum("...rv,...r->...v", A, w)

    def gram(d):
        return jnp.einsum("...rv,...r,...rw->...vw", A, d, A)

    # Delta reformulation around the warm start (see solve_qp_lsc):
    # solve for d = y - y0 so no iterate carries world-coordinate
    # magnitudes.  Exact up to a constant objective shift; obj is
    # recomputed at the full point below.
    if y0 is not None:
        q_d = q + jnp.einsum("...vw,...w->...v", P, y0)
        b_d = b - mv(y0)
        sol = _ipm(P, q_d, mv, rmv, gram, b_d, None, iters, reg,
                   s_min, correctors=correctors)
        y = y0 + sol.y
        obj = 0.5 * jnp.einsum("...v,...vw,...w->...", y, P, y) + \
            jnp.einsum("...v,...v->...", q, y)
        return sol._replace(y=y, obj=obj)

    return _ipm(P, q, mv, rmv, gram, b, y0, iters, reg, s_min,
                correctors=correctors)


def solve_qp_lsc(P, q, A_st, b_st, normal, rhs, mask, F_seg,
                 y0=None, iters: int = 20, reg: float = 1e-8,
                 s_min: float = 1.0, static_blocks=None,
                 tol_gap: float = 1e-3, tol_rp: float = 1e-4,
                 tol_rd: float = 0.05, tol_step: float = 0.0,
                 correctors: int = 0
                 ) -> QPSolution:
    """Factored-row QP solve for the production LSC/SFC path.

    Static rows (world bounds + dynamic limits) are one agent-shared
    matrix A_st (R_s, nv) with per-agent rhs b_st (N, R_s).  Every plane
    row is  normal_{c,m} (x) F_seg[m, i, :]  over the dim-major variable
    layout y = (3, nf):

        a_{c,m,i} . y = sum_k normal[c,m,k] * (F_seg[m,i,:] . y_k)

    normal: (N, C, M, 3); rhs/mask: (N, C, M, n+1); F_seg: (M, n+1, nf).
    Row equilibration uses |a| = |normal| * |F_seg[m,i]| exactly.
    Returns duals ordered [static rows, plane rows (c-major)].

    static_blocks (optional): (U (dim, Ru, nf), row_perm, inv_row_perm)
    from TrajOptimizer.static_blocked -- exploits the one-block-per-row
    sparsity and +- pairing of the static rows so their Gram is three
    (nf, nf) blocks instead of a dense (nv, nv) product (the dominant
    IPM cost at production sizes without it).
    """
    dtype = P.dtype
    N = P.shape[0]
    M, n1, nf = F_seg.shape
    C = normal.shape[1]
    nv = P.shape[-1]

    # per-instance objective scale: makes the early-exit gap / dual
    # tolerances relative to the ~1e4-1e5 jerk-Gram magnitude (the
    # solve itself stays on the RAW problem -- see _objective_sigma)
    sigma = _objective_sigma(P)

    F_seg = jnp.asarray(F_seg, dtype)
    A_st = jnp.asarray(A_st, dtype)

    # --- static rows: equilibrate once (rows are agent-shared), with
    #     the same degeneracy guards as _equilibrate_rows: near-zero
    #     rows (initial-state-determined) go inert, scaled bounds are
    #     capped so no far-inactive row poisons the centering mean ---
    st_norm = jnp.sqrt(jnp.sum(A_st * A_st, axis=-1) + 1e-12)
    st_dead = st_norm < 1e-3
    st_scale = 1.0 / jnp.maximum(st_norm, 1e-3)
    b_absmax = jnp.max(jnp.abs(b_st), axis=0)            # (R_s,)
    # static rows come in adjacent +- pairs sharing a row vector
    # (static_rows construction); the cap must be PAIR-symmetric or
    # the blocked one-scale-per-pair representation breaks
    b_absmax = jnp.repeat(
        jnp.max(b_absmax.reshape(-1, 2), axis=1), 2)
    st_scale = jnp.minimum(st_scale,
                           1e3 / jnp.maximum(b_absmax, 1.0))
    st_scale = jnp.where(st_dead, 0.0, st_scale)
    A_st = A_st * st_scale[:, None]
    b_st = jnp.where(st_dead[None, :], -1.0,
                     b_st * st_scale[None, :])

    if static_blocks is not None:
        U_np, row_perm_np, inv_row_perm_np = static_blocks
        ndim = U_np.shape[0]
        Ru = U_np.shape[1]
        # scale the unique +rows with their (pair-shared) row scale
        u_scale = st_scale[jnp.asarray(row_perm_np[0::2].copy())]
        U = jnp.asarray(U_np, dtype) * \
            u_scale.reshape(ndim, Ru)[..., None].astype(dtype)
        row_perm = jnp.asarray(row_perm_np)
        inv_row_perm = jnp.asarray(inv_row_perm_np)

    # --- plane rows: |a_{c,m,i}| = |n_{c,m}| |F_seg[m,i]|, same
    #     degeneracy guards ---
    f_norm = jnp.sqrt(jnp.sum(F_seg * F_seg, axis=-1))       # (M, n+1)
    n_norm = jnp.sqrt(jnp.sum(normal * normal, axis=-1))     # (N, C, M)
    row_norm = n_norm[..., None] * f_norm[None, None]        # (N,C,M,i)
    rhs_d = rhs.astype(dtype)
    scale = 1.0 / jnp.maximum(row_norm, 1e-3)
    scale = jnp.minimum(scale, 1e3 / jnp.maximum(jnp.abs(rhs_d), 1.0))
    live = mask & (row_norm >= 1e-3)
    scale = jnp.where(live, scale, 0.0)      # dead rows -> zero row
    b_pl = jnp.where(live, rhs_d * scale, -1.0)

    nsc = normal.astype(dtype)               # (N, C, M, kdim)
    kdim = normal.shape[-1]                  # 3, or 2 in 2-D mode
    R_s = A_st.shape[0]

    def mv_st(y):
        if static_blocks is None:
            return jnp.einsum("rv,nv->nr", A_st, y)
        y3 = y.reshape(N, ndim, nf)
        s_u = jnp.einsum("kuf,nkf->nku", U, y3)         # +row values
        pair = jnp.stack([s_u, -s_u], axis=-1)          # (N,k,Ru,2)
        return pair.reshape(N, R_s)[:, inv_row_perm]

    def rmv_st(w_st):
        if static_blocks is None:
            return jnp.einsum("rv,nr->nv", A_st, w_st)
        w_p = w_st[:, row_perm].reshape(N, ndim, Ru, 2)
        w_pair = w_p[..., 0] - w_p[..., 1]
        return jnp.einsum("kuf,nku->nkf", U, w_pair).reshape(N, nv)

    # static (M*n1, nf*nf) outer-product basis: turns the plane Gram
    # into ONE (kdim^2, M*n1) x (M*n1, nf*nf) matmul per agent instead
    # of a 3-operand contraction XLA may order badly
    FF = jnp.einsum("mif,mig->mifg", F_seg, F_seg)
    eye_k = jnp.eye(kdim, dtype=dtype)

    def gram_st_blocks(d_st):
        """(N, ndim, nf, nf) diagonal blocks of the static-row Gram
        (blocked path only)."""
        d_p = d_st[:, row_perm].reshape(N, ndim, Ru, 2)
        d_pair = d_p[..., 0] + d_p[..., 1]              # (N, k, Ru)
        return jnp.einsum("kuf,nku,kug->nkfg", U, d_pair, U)

    def mv(y):
        y3 = y.reshape(N, kdim, nf)
        x = jnp.einsum("mif,nkf->nkmi", F_seg, y3)    # (N,kdim,M,n+1)
        pl = jnp.einsum("ncmk,nkmi->ncmi", nsc, x) * scale
        return jnp.concatenate([mv_st(y), pl.reshape(N, -1)], axis=1)

    def rmv(w):
        w_pl = (w[:, R_s:].reshape(N, C, M, n1)) * scale
        v = jnp.einsum("ncmi,ncmk->nkmi", w_pl, nsc)
        r_pl = jnp.einsum("mif,nkmi->nkf", F_seg, v).reshape(N, nv)
        return rmv_st(w[:, :R_s]) + r_pl

    def gram(d):
        d_pl = (d[:, R_s:].reshape(N, C, M, n1)) * scale * scale
        W = jnp.einsum("ncmi,ncmk,ncml->nklmi", d_pl, nsc, nsc)
        H_pl = jnp.einsum("nklmi,mifg->nkflg", W, FF)
        if static_blocks is None:
            H_st = jnp.einsum("rv,nr,rw->nvw", A_st, d[:, :R_s],
                              A_st)
            return H_st + H_pl.reshape(N, nv, nv)
        # fold the block-diagonal static Gram into the plane Gram
        # without materializing a scattered (N, nv, nv) buffer
        H_blk = gram_st_blocks(d[:, :R_s])
        H_pl = H_pl + jnp.einsum("nkfg,kl->nkflg", H_blk, eye_k)
        return H_pl.reshape(N, nv, nv)

    q_orig = q
    if y0 is not None:
        # --- delta reformulation around the warm start ---
        # Solve for d = y - y0:  min 1/2 d'Pd + (Py0 + q)'d  s.t.
        # A d >= b - A y0.  Exact up to a constant objective shift,
        # but decisive for f32: iterates no longer carry the ~150 m
        # world-coordinate magnitudes, so P@d terms are ~1e3 instead
        # of ~1.5e6 and the dual residual r_d = P d + q_d - A'lam
        # evaluates with a ~5e-3 noise floor instead of the ~0.4
        # cancellation floor that kept the early exit from firing at
        # congested swarm scales (docs/TOLERANCES_r04.md section 3).
        # The one-time f32 rounding in q_d = P y0 + q is a CONSISTENT
        # O(eps sigma |y0|) perturbation of the problem's gradient
        # (solution displaced ~4e-5 m), not a per-iteration noise
        # term.  The initial point d = 0 has the same slacks as the
        # original warm start, so the Mehrotra trajectory is
        # identical in exact arithmetic.
        ay0 = mv(y0)
        b_st = b_st - ay0[:, :R_s]
        pl0 = ay0[:, R_s:].reshape(N, C, M, n1)
        b_pl = jnp.where(live, b_pl - pl0, -1.0)
        q = q + jnp.einsum("nvw,nw->nv", P, y0)
    b = jnp.concatenate([b_st, b_pl.reshape(N, C * M * n1)], axis=1)

    if y0 is not None:
        # warm-start feasibility diagnostic: the LSC-shifted previous
        # solution must be feasible by construction; a violation here
        # identifies a broken constraint source upstream, not an IPM
        # failure (the IPM cannot reduce primal infeasibility below
        # what an infeasible problem admits).  In delta coordinates
        # the warm point is d = 0, so its violation is b itself.
        warm_res = jnp.max(b, axis=-1)
        warm_row = jnp.argmax(b, axis=-1)
    else:
        warm_res = warm_row = None

    sol = _ipm(P, q, mv, rmv, gram, b, None, iters, reg, s_min,
               tol_gap=tol_gap, tol_rp=tol_rp, tol_rd=tol_rd,
               tol_scale=sigma, correctors=correctors,
               tol_step=tol_step)
    if y0 is not None:
        y = y0 + sol.y
        obj = 0.5 * jnp.einsum("nv,nvw,nw->n", y, P, y) + \
            jnp.einsum("nv,nv->n", q_orig, y)
        sol = sol._replace(y=y, obj=obj)
    return sol._replace(warm_res=warm_res, warm_row=warm_row)


def violation_report(A, b, y, mask=None, top_k: int = 5):
    """Per-row violations of A y >= b at y -- the conflict-refinement analog
    (traj_optimizer.cpp:104-137).  Returns (values, row indices), largest
    violations first."""
    A, b = _masked(A, b, mask)
    viol = b - jnp.einsum("...rv,...v->...r", A, y)
    vals, idx = jax.lax.top_k(viol, top_k)
    return vals, idx

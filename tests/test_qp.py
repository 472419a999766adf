"""Tests for the batched interior-point QP solver."""
import jax.numpy as jnp
import numpy as np

from lsc_planner_tpu.ops import qp


def make_qp_with_known_solution(rng, nv=12, nr=30, n_active=5):
    """Construct (P, q, A, b) whose optimum is a chosen y* via KKT."""
    L = rng.normal(size=(nv, nv))
    P = L @ L.T + nv * np.eye(nv)
    A = rng.normal(size=(nr, nv))
    y_star = rng.normal(size=(nv,))
    lam = np.zeros(nr)
    lam[:n_active] = rng.uniform(0.5, 2.0, size=n_active)
    # q chosen so stationarity holds: P y* + q - A' lam = 0
    q = A.T @ lam - P @ y_star
    b = A @ y_star.copy()
    b[:n_active] = A[:n_active] @ y_star          # active rows tight
    b[n_active:] = A[n_active:] @ y_star - rng.uniform(
        0.5, 3.0, size=nr - n_active)             # inactive rows slack
    return P, q, A, b, y_star


def test_recovers_known_solution(rng):
    Ps, qs, As, bs, ys = [], [], [], [], []
    for _ in range(16):
        P, q, A, b, y = make_qp_with_known_solution(rng)
        Ps.append(P), qs.append(q), As.append(A), bs.append(b), ys.append(y)
    sol = qp.solve_qp(jnp.asarray(np.stack(Ps)), jnp.asarray(np.stack(qs)),
                      jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
                      iters=25)
    np.testing.assert_allclose(np.asarray(sol.y), np.stack(ys),
                               rtol=1e-6, atol=1e-6)
    assert np.asarray(sol.primal_res).max() < 1e-8


def test_projection_problem(rng):
    """P = 2I, q = -2c: projection of c onto {Ay >= b}; verify KKT."""
    nv, nr = 6, 20
    c = rng.normal(size=(4, nv)) * 3
    A = rng.normal(size=(4, nr, nv))
    b = -np.abs(rng.normal(size=(4, nr))) - 0.1   # origin strictly feasible
    P = np.broadcast_to(2 * np.eye(nv), (4, nv, nv))
    q = -2 * c
    sol = qp.solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                      jnp.asarray(b), iters=30)
    y = np.asarray(sol.y)
    lam = np.asarray(sol.lam)
    # stationarity (note solver equilibrates rows internally; check in
    # original rows by recomputing residual with its own duals is skipped --
    # instead verify primal feasibility + objective optimality vs scipy)
    slack = np.einsum("brv,bv->br", A, y) - b
    assert slack.min() > -1e-7
    import scipy.optimize as sopt
    for k in range(4):
        res = sopt.minimize(
            lambda x: np.sum((x - c[k]) ** 2),
            np.zeros(nv),
            jac=lambda x: 2 * (x - c[k]),
            constraints=[{"type": "ineq",
                          "fun": lambda x: A[k] @ x - b[k],
                          "jac": lambda x: A[k]}],
            method="SLSQP", options={"maxiter": 200, "ftol": 1e-12})
        np.testing.assert_allclose(np.sum((y[k] - c[k]) ** 2), res.fun,
                                   rtol=1e-6, atol=1e-8)


def test_masked_rows_ignored(rng):
    P, q, A, b, y_star = make_qp_with_known_solution(rng)
    # append garbage rows, masked off
    A2 = np.concatenate([A, rng.normal(size=(8, A.shape[1])) * 100], axis=0)
    b2 = np.concatenate([b, np.full(8, 1e6)])
    mask = np.concatenate([np.ones(A.shape[0], bool), np.zeros(8, bool)])
    sol = qp.solve_qp(jnp.asarray(P[None]), jnp.asarray(q[None]),
                      jnp.asarray(A2[None]), jnp.asarray(b2[None]),
                      mask=jnp.asarray(mask[None]), iters=25)
    np.testing.assert_allclose(np.asarray(sol.y)[0], y_star, rtol=1e-6,
                               atol=1e-6)


def test_warm_start_consistency(rng):
    P, q, A, b, y_star = make_qp_with_known_solution(rng)
    y0 = jnp.asarray((y_star + rng.normal(size=y_star.shape) * 0.01)[None])
    sol = qp.solve_qp(jnp.asarray(P[None]), jnp.asarray(q[None]),
                      jnp.asarray(A[None]), jnp.asarray(b[None]),
                      y0=y0, iters=15)
    np.testing.assert_allclose(np.asarray(sol.y)[0], y_star, rtol=1e-5,
                               atol=1e-5)


def test_violation_report(rng):
    A = jnp.asarray(np.eye(4)[None])
    b = jnp.asarray(np.array([0.0, 2.0, -1.0, 5.0])[None])
    y = jnp.zeros((1, 4))
    vals, idx = qp.violation_report(A, b, y, top_k=2)
    assert int(idx[0, 0]) == 3 and float(vals[0, 0]) == 5.0
    assert int(idx[0, 1]) == 1 and float(vals[0, 1]) == 2.0


def test_blocked_static_gram_matches_generic(rng):
    """solve_qp_lsc with static_blocks (block-diag +- pair Gram) must match
    the generic static-row path on the production row structure."""
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from lsc_planner_tpu.config import Param
    from lsc_planner_tpu.planner.optimizer import TrajOptimizer

    opt = TrajOptimizer(Param())
    A_st = opt.A_static_y
    nv, nf = opt.nv, opt.nf
    N, C, M, n1 = 3, 4, opt.M, opt.n + 1

    L = rng.normal(size=(N, nv, nv)) * 0.3
    P = L @ np.swapaxes(L, -1, -2) + 2.0 * np.eye(nv)
    q = rng.normal(size=(N, nv))
    F_seg = opt.F_seg
    b_st = rng.normal(size=(N, A_st.shape[0])) - 5.0
    normal = rng.normal(size=(N, C, M, 3))
    rhs = rng.normal(size=(N, C, M, n1)) - 3.0
    mask = rng.uniform(size=(N, C, M, n1)) > 0.3

    kw = dict(y0=None, iters=20, tol_gap=0.0, tol_rp=0.0)
    generic = qp.solve_qp_lsc(
        jnp.asarray(P), jnp.asarray(q), jnp.asarray(A_st),
        jnp.asarray(b_st), jnp.asarray(normal), jnp.asarray(rhs),
        jnp.asarray(mask), jnp.asarray(F_seg), **kw)
    blocked = qp.solve_qp_lsc(
        jnp.asarray(P), jnp.asarray(q), jnp.asarray(A_st),
        jnp.asarray(b_st), jnp.asarray(normal), jnp.asarray(rhs),
        jnp.asarray(mask), jnp.asarray(F_seg),
        static_blocks=opt.static_blocked, **kw)
    np.testing.assert_allclose(np.asarray(blocked.y),
                               np.asarray(generic.y), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(blocked.lam),
                               np.asarray(generic.lam), rtol=1e-7,
                               atol=1e-9)


def _factored_vs_dense(rng, kdim):
    """solve_qp_lsc (factored plane rows) vs solve_qp on the equivalent
    dense row set a_{c,m,i} = normal_{c,m} (x) F_seg[m,i,:], with `kdim`
    coordinate blocks (3, or 2 for planar worlds)."""
    N, C, M, n1, nf = 3, 4, 5, 6, 13
    nv = kdim * nf

    L = rng.normal(size=(N, nv, nv)) * 0.3
    P = L @ np.swapaxes(L, -1, -2) + 2.0 * np.eye(nv)
    q = rng.normal(size=(N, nv))
    F_seg = rng.normal(size=(M, n1, nf))
    A_st = rng.normal(size=(20, nv))
    b_st = rng.normal(size=(N, 20)) - 3.0
    normal = rng.normal(size=(N, C, M, kdim))
    rhs = rng.normal(size=(N, C, M, n1)) - 3.0
    mask = rng.uniform(size=(N, C, M, n1)) > 0.3

    # dense equivalent
    A_pl = np.einsum("ncmk,mif->ncmikf", normal, F_seg)
    A_pl = A_pl.reshape(N, C * M * n1, nv)
    A = np.concatenate(
        [np.broadcast_to(A_st[None], (N,) + A_st.shape), A_pl], axis=1)
    b = np.concatenate([b_st, rhs.reshape(N, -1)], axis=1)
    m_all = np.concatenate(
        [np.ones((N, 20), bool), mask.reshape(N, -1)], axis=1)

    dense = qp.solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                        jnp.asarray(b), mask=jnp.asarray(m_all), iters=25)
    fact = qp.solve_qp_lsc(jnp.asarray(P), jnp.asarray(q),
                           jnp.asarray(A_st), jnp.asarray(b_st),
                           jnp.asarray(normal), jnp.asarray(rhs),
                           jnp.asarray(mask), jnp.asarray(F_seg),
                           iters=25, tol_gap=0.0, tol_rp=0.0)
    # both paths approach the same optimum; masked-row bookkeeping
    # perturbs the Mehrotra centering slightly, so compare at the
    # convergence tolerance rather than bitwise
    np.testing.assert_allclose(np.asarray(fact.y), np.asarray(dense.y),
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(fact.obj),
                               np.asarray(dense.obj), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(fact.primal_res),
                               np.asarray(dense.primal_res), atol=1e-6)


def test_factored_lsc_matches_dense(rng):
    """solve_qp_lsc (factored plane rows) must agree with solve_qp on the
    equivalent dense row set: a_{c,m,i} = normal_{c,m} (x) F_seg[m,i,:]."""
    _factored_vs_dense(rng, kdim=3)


def test_factored_lsc_matches_dense_2d(rng):
    """The same agreement with 2-D plane rows (planar worlds drop the z
    block: normals (..., 2), nv = 2 nf)."""
    _factored_vs_dense(rng, kdim=2)


def test_cholesky_solve_f32_matches_f64(rng):
    """The IPM's batched factor + substitutions at the 1024-agent
    production shape class (256, 39, 39) in f32 against numpy f64.

    The matrices are Jacobi-equilibrated SPD with condition ~1e4, like
    the IPM's scaled normal equations.  Cholesky is backward stable, so
    the relative residual |H x - r| / (|H| |x|) and the reconstruction
    error |L L^T - H| / |H| must sit at a small multiple of n * eps_f32
    (39 * 6e-8 = 2.3e-6; measured ~6e-8): bound 1e-5.  The forward
    error against the f64 solve is at most cond times the backward
    error (~1e4 * 6e-8 = 6e-4; measured ~8e-5): bound 1e-3."""
    B, n = 256, 39
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    H = np.einsum("bij,j,bkj->bik", Q, np.logspace(-4, 0, n), Q)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", H))
    H = H * d[:, :, None] * d[:, None, :]
    r = rng.normal(size=(B, n))
    L = qp._cholesky(jnp.asarray(H, jnp.float32))
    x = np.asarray(qp._chol_solve(L, jnp.asarray(r, jnp.float32)),
                   np.float64)
    assert L.dtype == jnp.float32 and x.shape == (B, n)
    L = np.asarray(L, np.float64)
    assert np.all(np.triu(L, 1) == 0.0)
    norm_h = np.linalg.norm(H, 2, axis=(1, 2))
    recon = np.linalg.norm(L @ np.swapaxes(L, -1, -2) - H, axis=(1, 2))
    assert (recon / np.linalg.norm(H, axis=(1, 2))).max() < 1e-5
    resid = np.linalg.norm(np.einsum("bij,bj->bi", H, x) - r, axis=1)
    assert (resid / (norm_h * np.linalg.norm(x, axis=1))).max() < 1e-5
    x64 = np.linalg.solve(H, r[..., None])[..., 0]
    fwd = np.linalg.norm(x - x64, axis=1) / np.linalg.norm(x64, axis=1)
    assert fwd.max() < 1e-3


def test_factored_solve_f32_matches_f64_at_128_agents(rng):
    """The factored solve at N = 128 (the sizes the removed fused kernel
    served) in f32 against f64, on the production row structure with a
    known optimum: y* is made optimal by construction (three tight plane
    rows per agent with positive duals, every other row slack 0.1-1).

    Tolerances: f64 reaches y* to ~6e-5 (the ridge and row-bound caps);
    f32 sits ~8e-4 from it, the f32 plateau of the IPM on near-parallel
    replicated plane rows.  Bounds: f64 within 1e-3 of y*, f32 within
    5e-3 of f64, f32 primal residual below 1e-5 m."""
    from lsc_planner_tpu.config import Param
    from lsc_planner_tpu.planner.optimizer import TrajOptimizer

    opt = TrajOptimizer(Param())
    A_st, F = opt.A_static_y, opt.F_seg
    nv, nf = opt.nv, opt.nf
    N, C, M, n1 = 128, 4, opt.M, opt.n + 1

    Lb = rng.normal(size=(N, nf, nf)) * 0.3
    P_blk = Lb @ np.swapaxes(Lb, -1, -2) + 2.0 * np.eye(nf)
    P = np.zeros((N, nv, nv))
    for k in range(3):
        P[:, k * nf:(k + 1) * nf, k * nf:(k + 1) * nf] = P_blk
    y_star = rng.normal(size=(N, nv)) * 0.5
    normal = rng.normal(size=(N, C, M, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    val = np.einsum("ncmk,nkmi->ncmi", normal, np.einsum(
        "mif,nkf->nkmi", F, y_star.reshape(N, 3, nf)))
    rhs = val - rng.uniform(0.1, 1.0, size=val.shape)
    q = -np.einsum("nvw,nw->nv", P, y_star)
    for a in range(N):
        for _ in range(3):            # tight rows with positive duals
            c, m, i = rng.integers(C), rng.integers(1, M), \
                rng.integers(3, n1)
            rhs[a, c, m, i] = val[a, c, m, i]
            q[a] += rng.uniform(0.5, 2.0) * np.einsum(
                "k,f->kf", normal[a, c, m], F[m, i]).reshape(nv)
    b_st = y_star @ A_st.T - rng.uniform(0.1, 1.0, size=(N, len(A_st)))
    mask = np.ones((N, C, M, n1), bool)
    y0 = y_star + rng.normal(size=y_star.shape) * 0.02

    def solve(dtype):
        args = [jnp.asarray(v, dtype) for v in (P, q, A_st, b_st, normal,
                                                rhs)]
        return qp.solve_qp_lsc(*args, jnp.asarray(mask),
                               jnp.asarray(F, dtype),
                               y0=jnp.asarray(y0, dtype), iters=25,
                               static_blocks=opt.static_blocked,
                               tol_gap=0.0, tol_rp=0.0, correctors=1)

    s64, s32 = solve(jnp.float64), solve(jnp.float32)
    assert s32.y.dtype == jnp.float32
    y64 = np.asarray(s64.y)
    y32 = np.asarray(s32.y, np.float64)
    assert np.abs(y64 - y_star).max() < 1e-3
    assert np.abs(y32 - y64).max() < 5e-3
    assert float(s32.primal_res.max()) < 1e-5


def test_gondzio_correctors_fix_degenerate_row_plateau():
    """The LSC structure replicates each neighbour's plane over ~M(n+1)
    near-identical rows; their degenerate duals stall plain Mehrotra in
    f32 (gap plateau ~1e-2 at congestion regardless of iteration count,
    docs/TOLERANCES_r03/r04).  Reproduced on a REAL captured instance:
    drive a 64-agent circle exchange into its congested phase, capture
    one cycle's QP, and require one centrality corrector to beat the
    corrector-less plateau by >= 10x at the same iteration count."""
    import math
    import jax
    from lsc_planner_tpu.config import Param, GoalMode
    from lsc_planner_tpu.missions import make_circle_mission
    from lsc_planner_tpu.sim.simulator import SyncSimulator

    qn = 64
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    mission = make_circle_mission(qn, radius=radius,
                                  world=(-w, -w, 0, w, w, 2.5))
    p = Param(goal_mode=GoalMode.PRIOR_BASED)
    sim = SyncSimulator(mission, p, dtype=jnp.float32)
    state = sim.initial_state()
    for _ in range(40):                      # into the crossing phase
        state, _ = sim._cycle_jit(state)

    captured = {}
    orig = qp.solve_qp

    def capture(*a, **k):
        captured["a"], captured["k"] = a, dict(k)
        return orig(*a, **k)

    qp.solve_qp = capture
    try:
        pos, vel, acc = sim.propagate(state)
        init, pred = sim.predict_and_init(state.traj, pos, vel, state.seq,
                                          prev_goal=state.current_goal)
        sim.plan_block(
            pos, vel, acc, init, state.seq, pred_global=pred,
            obs_pos_global=pos, obs_goal_global=state.desired_goal,
            obs_prev_global=state.traj,
            self_mask=jnp.eye(qn, dtype=bool),
            radius=sim.radius, downwash=sim.downwash,
            nominal_velocity=sim.nominal_velocity, max_vel=sim.max_vel,
            max_acc=sim.max_acc, desired_goal=state.desired_goal,
            sfc_prev=state.sfc, sfc_initialize=~state.sfc_initialized,
            sfc_seed=state.traj[:, -1, -1, :])
    finally:
        qp.solve_qp = orig
    P, q, A, b = captured["a"][:4]
    kk = captured["k"]

    gaps = {}
    for corr in (0, 1):
        sol = qp.solve_qp(P, q, A, b, mask=kk.get("mask"),
                          y0=kk.get("y0"), iters=14, correctors=corr)
        gaps[corr] = float(jnp.max(sol.gap))
    # the plateau magnitude depends on the closed-loop state the capture
    # lands on (1e-6 .. 1e-2 observed; the round-5 delta-coordinate
    # reformulation of the solve shrank it by ~an order of magnitude on
    # this capture); the invariant property is the corrector's
    # order-of-magnitude improvement at equal iterations
    assert gaps[0] > 2e-6, f"capture not congested enough: {gaps}"
    assert gaps[1] < gaps[0] / 10.0, gaps

"""Bernstein-polynomial algebra, batched over agents and segments.

Covers the capability surface of the reference header-only polynomial library
(``include/polynomial.hpp``): basis construction, curve evaluation,
derivative control points, flat-output state extraction with body rates,
least-squares fitting, subdivision, and the jerk-cost Gram matrix used by the
trajectory QP (``src/traj_optimizer.cpp:169-184`` buildQBase).

Design notes:
 - All static, shape-only matrices (basis-change B, Q_base, subdivision A)
   are built once in float64 numpy at setup and cast to the device dtype;
   nothing here branches on traced values.
 - Curve evaluation is expressed as small matmul/einsum contractions over a
   trailing (n+1) axis so XLA fuses them; callers vmap over agents/segments.
   These contractions run at the caller's matmul precision: the planning
   cycle traces them at full f32 (runtime.exact_f32).
"""
from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

GRAVITY = 9.81


def nchoosek(n: int, k: int) -> int:
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


def coef_derivative(i: int, k: int) -> int:
    """Falling factorial i*(i-1)*...*(i-k+1); 0 when i < k
    (reference polynomial.hpp:224-234)."""
    if i < k:
        return 0
    c = 1
    for j in range(k):
        c *= i - j
    return c


@lru_cache(maxsize=None)
def bernstein_matrix(n: int) -> np.ndarray:
    """Bernstein->monomial basis-change matrix B, (n+1, n+1) float64.

    Defined such that for control points c (shape n+1) the monomial
    coefficients of p(t) = sum_i c_i b_{i,n}(t) are  a = B^T c, i.e.
    p(t) = sum_j (B^T c)_j t^j.  Matches buildBernsteinBasis
    (polynomial.hpp:415-428): B[i, j] = C(n,i) C(n-i,n-j) (-1)^{j-i}, j>=i.
    """
    B = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        for j in range(i, n + 1):
            B[i, j] = nchoosek(n, i) * nchoosek(n - i, n - j) * (-1.0) ** (j - i)
    return B


@lru_cache(maxsize=None)
def bernstein_matrix_inv(n: int) -> np.ndarray:
    return np.linalg.inv(bernstein_matrix(n))


def bernstein_basis(n: int, t):
    """Row of basis values b_{i,n}(t) for traced t; shape t.shape + (n+1,)."""
    t = jnp.asarray(t)
    i = jnp.arange(n + 1)
    binom = jnp.asarray([nchoosek(n, k) for k in range(n + 1)],
                        dtype=t.dtype)
    tt = t[..., None]
    # t^i (1-t)^(n-i) with 0^0 := 1 handled via where
    def safe_pow(base, expo):
        return jnp.where(expo == 0, 1.0, base[...] ** expo)
    return binom * safe_pow(tt, i) * safe_pow(1.0 - tt, n - i)


def bernstein_eval(ctrl, t):
    """Evaluate a Bernstein curve at normalized time t in [0, 1].

    ctrl: (..., n+1, d) control points;  t: scalar or broadcastable to (...,).
    Returns (..., d).  (reference getPointFromControlPoints,
    polynomial.hpp:26-61)
    """
    n = ctrl.shape[-2] - 1
    basis = bernstein_basis(n, jnp.asarray(t, dtype=ctrl.dtype))
    return jnp.einsum("...i,...id->...d", basis, ctrl)


def derivative_ctrl(ctrl, seg_time):
    """Control points of the derivative curve: n*(c_{i+1}-c_i)/T.
    ctrl: (..., n+1, d) -> (..., n, d)."""
    n = ctrl.shape[-2] - 1
    return (ctrl[..., 1:, :] - ctrl[..., :-1, :]) * (n / seg_time)


def traj_state(traj, t, dt):
    """Flat-output state extraction along a piecewise Bernstein trajectory.

    traj: (M, n+1, 3) control points, segment time dt; t: scalar time in
    [0, M*dt].  Returns dict(pos, vel, acc, jerk, omega) -- position through
    jerk plus body rates from the thrust direction (reference
    getStateFromControlPoints, polynomial.hpp:63-121).
    Fully traceable: segment index via clamped floor division.
    """
    M, npts, d = traj.shape
    n = npts - 1
    tt = jnp.asarray(t, dtype=traj.dtype)
    m = jnp.clip(jnp.floor(tt / dt).astype(jnp.int32), 0, M - 1)
    tau = tt / dt - m.astype(traj.dtype)
    seg = traj[m]                                # (n+1, 3)
    vel_c = derivative_ctrl(seg, dt)             # (n, 3)
    acc_c = derivative_ctrl(vel_c, dt)           # (n-1, 3)
    jerk_c = derivative_ctrl(acc_c, dt)          # (n-2, 3)
    pos = bernstein_eval(seg, tau)
    vel = bernstein_eval(vel_c, tau)
    acc = bernstein_eval(acc_c, tau)
    jerk = bernstein_eval(jerk_c, tau)

    thrust = acc + jnp.array([0.0, 0.0, GRAVITY], dtype=traj.dtype)
    tnorm = jnp.linalg.norm(thrust)
    z_body = thrust / jnp.maximum(tnorm, 1e-9)
    x_world = jnp.array([1.0, 0.0, 0.0], dtype=traj.dtype)
    y_body = jnp.cross(z_body, x_world)
    y_body = y_body / jnp.maximum(jnp.linalg.norm(y_body), 1e-9)
    x_body = jnp.cross(y_body, z_body)
    jerk_orth = jerk - z_body * jnp.dot(jerk, z_body)
    h_w = jerk_orth / jnp.maximum(tnorm, 1e-9)
    omega = jnp.stack([-jnp.dot(h_w, y_body), jnp.dot(h_w, x_body),
                       jnp.zeros((), dtype=traj.dtype)])
    return {"pos": pos, "vel": vel, "acc": acc, "jerk": jerk, "omega": omega}


def traj_state_batch(trajs, t, dt):
    """vmap of traj_state over a leading agent axis: trajs (N, M, n+1, 3)."""
    return jax.vmap(lambda tr: traj_state(tr, t, dt))(trajs)


def bernstein_fitting(targets, ts):
    """Least-squares control points through target points at normalized
    times (reference bernsteinFitting, polynomial.hpp:198-222).
    targets: (n+1, d), ts: (n+1,). Exact interpolation (square system).
    """
    n = targets.shape[0] - 1
    basis = bernstein_basis(n, ts)    # (n+1, n+1): rows = times
    return jnp.linalg.solve(basis, targets)


@lru_cache(maxsize=None)
def q_base(n: int, phi: int, phi_n: int, dt: float) -> np.ndarray:
    """Per-segment derivative-energy Gram matrix in control-point space.

    Q[i,j] = sum_{k=phi-phi_n+1..phi} dt^{1-2k} *
             (B Z_k B^T)[i,j],  Z_k[i,j] = c(i,k) c(j,k) / (i+j-2k+1)
    (reference buildQBase, traj_optimizer.cpp:169-184).  The QP cost per
    dimension is  c^T Q c  summed over segments.
    """
    B = bernstein_matrix(n)
    Q = np.zeros((n + 1, n + 1))
    for k in range(phi, phi - phi_n, -1):
        Z = np.zeros((n + 1, n + 1))
        for i in range(n + 1):
            for j in range(n + 1):
                if i + j - 2 * k + 1 > 0:
                    Z[i, j] = (coef_derivative(i, k) * coef_derivative(j, k)
                               / (i + j - 2 * k + 1))
        Z = B @ Z @ B.T
        Q += Z * dt ** (-2 * k + 1)
    return Q


@lru_cache(maxsize=None)
def subdivision_matrix(n: int, a: float, b: float) -> np.ndarray:
    """Matrix S with c_sub = S^T applied on control points: restriction of a
    Bernstein curve to [a, b] re-expressed in Bernstein form (reference
    subdivisionBernsteinCurve, polynomial.hpp:430-455).

    Returns (n+1, n+1) S such that new control points = c @ S for row-vector
    c (i.e. einsum('...i,ij->...j', ctrl, S) per dimension).
    """
    B = bernstein_matrix(n)
    A = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        for j in range(i + 1):
            A[i, j] = nchoosek(i, j) * (a ** j) * (b ** (i - j))
    return B @ A @ np.linalg.inv(B)


def subdivide(ctrl, a: float, b: float):
    """Restrict Bernstein curve to sub-interval; ctrl (..., n+1, d)."""
    n = ctrl.shape[-2] - 1
    S = jnp.asarray(subdivision_matrix(n, a, b), dtype=ctrl.dtype)
    return jnp.einsum("ji,...jd->...id", S, ctrl)


# ----------------------------------------------------------------------
# real-root isolation + minimum distance between Bernstein curves
# (reference realRootIsolation / distanceBetweenPolys,
#  polynomial.hpp:243-413)
# ----------------------------------------------------------------------

def power_coeffs(ctrl):
    """Monomial coefficients (ascending) of a Bernstein curve.

    ctrl: (..., n+1) scalar control points -> (..., n+1) with
    p(t) = sum_j a_j t^j.  Matches the reference's ``coef = c^T B``
    conversion (polynomial.hpp:334-340).
    """
    n = ctrl.shape[-1] - 1
    B = jnp.asarray(bernstein_matrix(n), dtype=ctrl.dtype)
    return jnp.einsum("...i,ij->...j", ctrl, B)


def poly_eval(coef, t):
    """Horner evaluation of ascending monomial coefficients.
    coef: (..., D+1); t broadcastable against (...,)."""
    t = jnp.asarray(t, dtype=coef.dtype)
    out = jnp.zeros(jnp.broadcast_shapes(coef.shape[:-1], t.shape),
                    coef.dtype)
    for j in range(coef.shape[-1] - 1, -1, -1):
        out = out * t + coef[..., j]
    return out


@lru_cache(maxsize=None)
def _conv_onehot(d0: int, d1: int) -> np.ndarray:
    """T[j0, j1, j] = 1 iff j0 + j1 == j, for polynomial products."""
    T = np.zeros((d0, d1, d0 + d1 - 1))
    for j0 in range(d0):
        for j1 in range(d1):
            T[j0, j1, j0 + j1] = 1.0
    return T


def poly_multiply(a, b):
    """Product of two ascending-coefficient polynomials, batched.
    a: (..., D0+1), b: (..., D1+1) -> (..., D0+D1+1)."""
    T = jnp.asarray(_conv_onehot(a.shape[-1], b.shape[-1]), dtype=a.dtype)
    return jnp.einsum("...a,...b,abj->...j", a, b, T)


def real_roots(coef, n_grid: int = 64, iters: int = 40):
    """Roots of p in [0, 1]: sign-change bracketing + fixed bisection.

    Batched re-design of the reference's Descartes/bisection queue
    (realRootIsolation, polynomial.hpp:243-299): instead of a dynamic
    work queue, brackets are isolated on a uniform n_grid sampling (exact
    whenever adjacent roots are > 1/n_grid apart; the planner's degree-9
    dot-product polynomials satisfy this except at coincident-curve
    degeneracies, where the distance answer is unaffected) and refined
    with a fixed-trip bisection so the whole search is one fused batched
    program.

    coef: (..., D+1) ascending.  Returns (roots (..., n_grid), mask):
    root k lies in grid cell k; masked entries hold 1.0.
    """
    ts = jnp.linspace(0.0, 1.0, n_grid + 1).astype(coef.dtype)
    vals = poly_eval(coef[..., None, :], ts)            # (..., n_grid+1)
    sign_lo = vals[..., :-1]
    sign_hi = vals[..., 1:]
    bracket = sign_lo * sign_hi < 0.0                   # strict change
    exact = sign_lo == 0.0                              # grid-point root

    lo = jnp.broadcast_to(ts[:-1], bracket.shape)
    hi = jnp.broadcast_to(ts[1:], bracket.shape)
    neg_lo = sign_lo < 0.0                              # orientation

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        gm = poly_eval(coef[..., None, :], mid)
        go_right = jnp.where(neg_lo, gm < 0.0, gm > 0.0)
        return jnp.where(go_right, mid, lo), jnp.where(go_right, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    roots = jnp.where(exact, jnp.broadcast_to(ts[:-1], bracket.shape),
                      0.5 * (lo + hi))
    mask = bracket | exact
    return jnp.where(mask, roots, 1.0), mask


def curve_pair_min_distance(ctrl_a, ctrl_b, n_grid: int = 64,
                            iters: int = 40):
    """Minimum distance between two time-aligned Bernstein curves on [0,1].

    ctrl_a/ctrl_b: (..., n+1, d).  Returns (dist, closest_rel_point) with
    dist (...,), closest (..., d) = a(t*) - b(t*).

    Follows distanceBetweenPolys (polynomial.hpp:310-413): form the
    relative curve, build g(t) = <delta, delta'> in the monomial basis,
    locate interior minima (g crossing - to +) and bisect each to
    tolerance.  Divergence from the reference: the result also includes
    both endpoints in the min even when interior minima exist (the
    reference falls back to endpoints only when no interior candidate is
    found, which can over-report the distance when an endpoint is the
    true minimizer) -- ours is a true lower bound, never larger.
    """
    rel = ctrl_a - ctrl_b                                # (..., n+1, d)
    coef = power_coeffs(jnp.swapaxes(rel, -1, -2))       # (..., d, n+1)
    j = jnp.arange(1, coef.shape[-1], dtype=coef.dtype)
    dcoef = coef[..., 1:] * j                            # (..., d, n)
    g = jnp.sum(poly_multiply(coef, dcoef), axis=-2)     # (..., 2n)

    ts = jnp.linspace(0.0, 1.0, n_grid + 1).astype(g.dtype)
    vals = poly_eval(g[..., None, :], ts)                # (..., n_grid+1)
    # minima: g goes negative -> non-negative (distance decreasing then
    # increasing), matching the reference's g(a)<0 and g(b)>0 filter
    bracket = (vals[..., :-1] < 0.0) & (vals[..., 1:] > 0.0)

    lo = jnp.broadcast_to(ts[:-1], bracket.shape)
    hi = jnp.broadcast_to(ts[1:], bracket.shape)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        gm = poly_eval(g[..., None, :], mid)
        return (jnp.where(gm < 0.0, mid, lo),
                jnp.where(gm < 0.0, hi, mid))

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    t_cand = 0.5 * (lo + hi)                             # (..., n_grid)

    p_cand = bernstein_eval(rel[..., None, :, :], t_cand)
    d_cand = jnp.linalg.norm(p_cand, axis=-1)            # (..., n_grid)
    d_cand = jnp.where(bracket, d_cand, jnp.inf)

    d0 = jnp.linalg.norm(rel[..., 0, :], axis=-1)
    d1 = jnp.linalg.norm(rel[..., -1, :], axis=-1)
    all_d = jnp.concatenate(
        [d_cand, d0[..., None], d1[..., None]], axis=-1)
    all_p = jnp.concatenate(
        [p_cand, rel[..., 0:1, :], rel[..., -1:, :]], axis=-2)
    k = jnp.argmin(all_d, axis=-1)
    dist = jnp.take_along_axis(all_d, k[..., None], axis=-1)[..., 0]
    closest = jnp.take_along_axis(all_p, k[..., None, None],
                                  axis=-2)[..., 0, :]
    return dist, closest

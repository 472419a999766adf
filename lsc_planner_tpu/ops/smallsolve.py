"""Unrolled linear solvers for tiny (k <= 8) batched systems.

Cholesky and forward/backward substitution written as elementwise ops on
the trailing (k, k) entries, so XLA fuses them over any batch shape with
no library call per system.  Nothing on the planning cycle calls these
today (the hull solve scalarizes its own systems, ops/hull.py); they are
kept as the unrolled alternative to the IPM's batched Cholesky, which
has not been measured on the H100 (ROADMAP 1.1).
"""
from __future__ import annotations

import jax.numpy as jnp


def cholesky_small(G, ridge: float = 0.0):
    """Unrolled Cholesky of PSD G (..., k, k) for static small k.

    Returns L lower-triangular with L L^T = G + ridge*I.  Singular inputs
    produce zero pivot columns (guarded division), making the subsequent
    solves return large-but-finite values that downstream feasibility
    filters reject.
    """
    k = G.shape[-1]
    eps = jnp.asarray(1e-30, G.dtype)
    cols = []
    L = [[None] * k for _ in range(k)]
    for j in range(k):
        s = G[..., j, j] + ridge
        for p in range(j):
            s = s - L[j][p] * L[j][p]
        diag = jnp.sqrt(jnp.maximum(s, eps))
        L[j][j] = diag
        inv_diag = 1.0 / diag
        for i in range(j + 1, k):
            s = G[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s * inv_diag
    return L


def solve_psd_small(G, rhs, ridge: float = 0.0):
    """Solve (G + ridge I) x = rhs via the unrolled Cholesky.

    G: (..., k, k) PSD; rhs: (..., k).  Static small k.
    """
    k = G.shape[-1]
    L = cholesky_small(G, ridge)
    # forward substitution: L y = rhs
    y = [None] * k
    for i in range(k):
        s = rhs[..., i]
        for p in range(i):
            s = s - L[i][p] * y[p]
        y[i] = s / L[i][i]
    # backward substitution: L^T x = y
    x = [None] * k
    for i in reversed(range(k)):
        s = y[i]
        for p in range(i + 1, k):
            s = s - L[p][i] * x[p]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def min_norm_weights(G, ridge: float = 0.0):
    """Solve the bordered min-norm KKT  [G 1; 1' 0] [lam; nu] = [0; 1]
    via the PSD Schur complement:  lam = G^{-1} 1 / (1' G^{-1} 1).

    G: (..., k, k) PSD Gram of the subset points.  Returns lam (..., k).
    Degenerate subsets yield non-finite or negative lam which callers
    filter out.
    """
    k = G.shape[-1]
    ones = jnp.ones(G.shape[:-2] + (k,), G.dtype)
    w = solve_psd_small(G, ones, ridge)
    denom = jnp.sum(w, axis=-1, keepdims=True)
    return w / denom

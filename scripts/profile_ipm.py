#!/usr/bin/env python
"""Micro-profile of the IPM linear algebra at production shapes.

Times each sub-operation of one IPM iteration at (B=1024, nv=39) on the
default device: Gram formation (factored rows), Cholesky, and the 4
triangular solves per iteration.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

B, NV = 1024, 39
C, M, N1 = 38, 5, 6   # neighbours+SFC, segments, ctrl pts
R_S = 414
NF = 13

key = jax.random.PRNGKey(0)


def timeit(name, fn, *args, reps=20):
    fn(*args)[0].block_until_ready() if isinstance(fn(*args), tuple) else \
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:34s} {dt*1e3:8.3f} ms")
    return dt


def main():
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    X = jax.random.normal(k1, (B, NV, NV), jnp.float32)
    H = jnp.einsum("bij,bkj->bik", X, X) + 10.0 * jnp.eye(NV)
    rhs = jax.random.normal(k2, (B, NV), jnp.float32)
    d = jax.random.uniform(k3, (B, R_S + C * M * N1), jnp.float32) + 0.1
    nsc = jax.random.normal(k4, (B, C, M, 3), jnp.float32)
    F_seg = jax.random.normal(k5, (M, N1, NF), jnp.float32)
    A_st = jax.random.normal(k1, (R_S, NV), jnp.float32)
    scale = jnp.ones((B, C, M, N1), jnp.float32)

    with jax.default_matmul_precision("highest"):
        chol_x = jax.jit(jnp.linalg.cholesky)

        def tri2(L, r):
            z = jax.lax.linalg.triangular_solve(
                L, r[..., None], left_side=True, lower=True)
            return jax.lax.linalg.triangular_solve(
                L, z, left_side=True, lower=True, transpose_a=True)[..., 0]
        tri2_j = jax.jit(tri2)

        def gram(dv):
            d_st = dv[:, :R_S]
            d_pl = (dv[:, R_S:].reshape(B, C, M, N1)) * scale * scale
            H_st = jnp.einsum("rv,nr,rw->nvw", A_st, d_st, A_st)
            W = jnp.einsum("ncmi,ncmk,ncml->nklmi", d_pl, nsc, nsc)
            H_pl = jnp.einsum("nklmi,mif,mig->nkflg", W, F_seg, F_seg)
            return H_st + H_pl.reshape(B, NV, NV)
        gram_j = jax.jit(gram)

        L = chol_x(H)
        timeit("xla cholesky (1024,39,39)", chol_x, H)
        timeit("2x triangular_solve", tri2_j, L, rhs)
        timeit("factored gram", gram_j, d)

        def iter_la(Hm, r):
            Lm = jnp.linalg.cholesky(Hm)
            x1 = tri2(Lm, r)
            x2 = tri2(Lm, r + x1)
            return x2
        timeit("chol + 4 trisolves", jax.jit(iter_la), H, rhs)


if __name__ == "__main__":
    main()

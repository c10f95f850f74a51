"""Tiny fixed-size linear algebra, fully unrolled.

``jnp.linalg.solve`` lowers a 6x6 solve to XLA's pivoted LU — a loopy,
latency-heavy program that sits on the critical path of every Gauss-Newton
iteration (the reference does one LDLT per round, picp_solver.cpp:109; we
do 100 per frame inside a scan). For the SPD systems GN produces
(H = sum wJᵀJ + damping*I), an unrolled Cholesky is a few dozen fused
scalar FLOPs with zero control flow that XLA fuses into one kernel.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray


def cholesky_solve(h: Array, b: Array, n: int = 6, eps: float = 1e-30) -> Array:
    """Solve ``h x = b`` for SPD ``h`` of static size (..., n, n), unrolled.

    Equivalent to the reference's ``H.ldlt().solve(b)`` (picp_solver.cpp:109)
    for SPD H. ``eps`` guards the pivots so an all-masked (zero) system
    degrades to x ~ b/eps-free zeros rather than NaN (callers gate on
    weights anyway).
    """
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = h[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(s, eps))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return jnp.stack(x, -1)


def solve_2x2(a00: Array, a01: Array, a11: Array, b0: Array, b1: Array, eps: float = 1e-12):
    """Closed-form symmetric 2x2 solve; returns (x0, x1, det)."""
    det = a00 * a11 - a01 * a01
    safe = jnp.where(jnp.abs(det) < eps, 1.0, det)
    return (a11 * b0 - a01 * b1) / safe, (a00 * b1 - a01 * b0) / safe, det

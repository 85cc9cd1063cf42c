"""Iterative solvers built on the SpMV kernels — the "model families".

The reference stops at the kernel (its application layer is the benchmark
REPL, ``software/main.cpp``); a usable sparse library carries the standard
iterative methods on top.  Everything here is a pure function of a
``matvec`` callable (any of: the jnp reference executor, a planned
operator, or the sharded executor), so every solver runs single-chip or
multi-chip unchanged, under ``jit``/``grad``.

All loops are ``lax.while_loop``/``lax.scan`` — fixed trip counts or
residual-tested with static maximum, no Python control flow in the traced
path.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

Array = Any
MatVec = Callable[[Array], Array]


class SolveResult(NamedTuple):
    x: Array
    iterations: Array       # int32
    residual_norm: Array    # float


def cg(matvec: MatVec, b: Array, x0: Optional[Array] = None, *,
       tol: float = 1e-6, maxiter: int = 100,
       M: Optional[MatVec] = None) -> SolveResult:
    """Conjugate gradient for SPD systems, optionally preconditioned."""
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = r if M is None else M(r)
    p = z
    rz = jnp.vdot(r, z)
    bnorm = jnp.linalg.norm(b)
    atol2 = (tol * jnp.maximum(bnorm, 1e-30)) ** 2

    def cond(state):
        _, r, _, _, k = state
        return jnp.logical_and(k < maxiter, jnp.vdot(r, r).real > atol2)

    def body(state):
        x, r, p, rz, k = state
        ap = matvec(p)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = r if M is None else M(r)
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, k + 1

    x, r, _, _, k = jax.lax.while_loop(
        cond, body, (x, r, p, rz, jnp.int32(0)))
    return SolveResult(x=x, iterations=k, residual_norm=jnp.linalg.norm(r))


def cg_step(matvec: MatVec, state: Tuple[Array, Array, Array, Array]):
    """One CG iteration as a standalone jittable step (flagship forward)."""
    x, r, p, rz = state
    ap = matvec(p)
    alpha = rz / jnp.vdot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    rz_new = jnp.vdot(r, r)
    p = r + (rz_new / rz) * p
    return x, r, p, rz_new


def bicgstab(matvec: MatVec, b: Array, x0: Optional[Array] = None, *,
             tol: float = 1e-6, maxiter: int = 100) -> SolveResult:
    """BiCGSTAB for general (non-symmetric) systems."""
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    bnorm = jnp.linalg.norm(b)
    atol2 = (tol * jnp.maximum(bnorm, 1e-30)) ** 2

    def cond(state):
        x, r, p, v, rho, alpha, omega, k = state
        return jnp.logical_and(k < maxiter, jnp.vdot(r, r).real > atol2)

    def body(state):
        x, r, p, v, rho, alpha, omega, k = state
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = matvec(p)
        alpha = rho_new / jnp.vdot(rhat, v)
        s = r - alpha * v
        t = matvec(s)
        omega = jnp.vdot(t, s) / jnp.maximum(jnp.vdot(t, t).real, 1e-30)
        x = x + alpha * p + omega * s
        r = s - omega * t
        return x, r, p, v, rho_new, alpha, omega, k + 1

    one = jnp.asarray(1.0, b.dtype)
    state = (x, r, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
             jnp.int32(0))
    x, r, *_, k = jax.lax.while_loop(cond, body, state)
    return SolveResult(x=x, iterations=k, residual_norm=jnp.linalg.norm(r))


def jacobi(matvec: MatVec, diag: Array, b: Array,
           x0: Optional[Array] = None, *, iters: int = 50,
           omega: float = 1.0) -> Array:
    """(Weighted) Jacobi iteration: x += omega * (b - A x) / diag."""
    x = jnp.zeros_like(b) if x0 is None else x0
    inv_d = jnp.where(diag != 0, 1.0 / diag, 0.0)

    def body(x, _):
        x = x + omega * inv_d * (b - matvec(x))
        return x, None

    x, _ = jax.lax.scan(body, x, None, length=iters)
    return x


def power_iteration(matvec: MatVec, v0: Array, *, iters: int = 50
                    ) -> Tuple[Array, Array]:
    """Dominant eigenpair by power iteration."""
    def body(v, _):
        w = matvec(v)
        v = w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
        return v, None

    v, _ = jax.lax.scan(body, v0 / jnp.linalg.norm(v0), None, length=iters)
    lam = jnp.vdot(v, matvec(v))
    return lam, v


def pagerank(matvec_transpose: MatVec, n: int, *, damping: float = 0.85,
             iters: int = 50, dtype=jnp.float32) -> Array:
    """PageRank over a column-stochastic link matrix ``P``: the matvec must
    compute ``P @ r`` (use the CSC/CSR duality to get the transpose free)."""
    r = jnp.full((n,), 1.0 / n, dtype)

    def body(r, _):
        r = damping * matvec_transpose(r) + (1.0 - damping) / n
        return r / jnp.sum(r), None

    r, _ = jax.lax.scan(body, r, None, length=iters)
    return r

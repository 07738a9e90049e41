"""Iterative solvers: preconditioned Richardson (LoopSolver) and CG.

Counterpart of ``src/solver/loop_solver.{hh,cc}`` and
``iterative_solver.hh``.  Two execution modes:

* :meth:`LoopSolver.solve` - host-driven loop with per-iteration residual /
  contraction-rate reporting, mirroring the reference verbose output
  (``loop_solver.cc:22-32``);
* :meth:`LoopSolver.solve_jit` - a ``lax.while_loop`` fully on device for
  production use (no host sync per iteration).

The residual convention matches the reference: ``r = A x - b``, update
``x <- x - P r`` (``loop_solver.cc:26-41``), converged when
``||r||/||r_0|| < rtol`` and ``||r|| < atol``.

A preconditioned conjugate-gradient solver is provided as well - the natural
companion for SPD lattice systems (not present in the reference, which only
ships Richardson; CG typically converges in fewer V-cycles).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class IterativeSolverParameters:
    """cf. ``src/solver/iterative_solver.hh:21-45``."""

    rtol: float = 1e-12
    atol: float = 1e-15
    maxiter: int = 100
    verbose: int = 0


@dataclasses.dataclass
class SolveResult:
    x: jax.Array
    converged: bool
    niter: int
    rnorm: float
    rnorm_history: Optional[list] = None


class LoopSolver:
    """Preconditioned Richardson iteration (``loop_solver.cc:9-54``)."""

    def __init__(self, op, preconditioner, params: IterativeSolverParameters = None):
        self.op = op
        self.preconditioner = preconditioner
        self.params = params or IterativeSolverParameters()

    def solve(self, b: jax.Array) -> SolveResult:
        p = self.params

        # one operator application + one preconditioner cycle per iteration,
        # fused into a single dispatch (the reference computes r once and
        # reuses it for both the norm and the update, loop_solver.cc:26-41)
        @jax.jit
        def step(x, b):
            r = self.op.apply(x) - b
            return x - self.preconditioner.apply(r), jnp.linalg.norm(r)

        r0_nrm = float(jnp.linalg.norm(b))
        if p.verbose >= 2:
            print(f"Initial residual ||r_0|| = {r0_nrm:12.4f}")
            print(f"{'iter':>5}   {'||r||':>8}   {'||r||/||r_0||':>12}   {'rho':>6}")
        x = jnp.zeros_like(b)
        rold_nrm = r0_nrm
        history = []
        converged, niter, r_nrm = False, p.maxiter, r0_nrm
        for k in range(p.maxiter):
            x_new, r_nrm_dev = step(x, b)
            r_nrm = float(r_nrm_dev)
            history.append(r_nrm)
            if p.verbose >= 2:
                print(f"{k:5d}   {r_nrm:8.3e}   {r_nrm / r0_nrm:12.3e}   {r_nrm / rold_nrm:6.3f}")
            if r_nrm / r0_nrm < p.rtol and r_nrm < p.atol:
                converged, niter = True, k
                break
            rold_nrm = r_nrm
            x = x_new
        if p.verbose >= 1:
            if converged:
                print(f"Solver converged after {niter:5d} iterations")
                print(f"||r|| = {r_nrm:8.3e}, ||r||/||r_0|| = {r_nrm / r0_nrm:8.3e}")
            else:
                print(f"Solver failed to converge after {p.maxiter:5d} iterations")
        return SolveResult(x, converged, niter, r_nrm, history)

    def solve_jit(self, b: jax.Array) -> SolveResult:
        """Device-resident ``lax.while_loop`` version: the entire Richardson
        iteration runs in one dispatch, one operator application per iteration
        (the residual is carried in the loop state)."""
        p = self.params

        @jax.jit
        def run(b):
            r0_nrm = jnp.linalg.norm(b)

            def cond(state):
                k, x, r, r_nrm = state
                return (k < p.maxiter) & ~((r_nrm / r0_nrm < p.rtol) & (r_nrm < p.atol))

            def body(state):
                k, x, r, _ = state
                x = x - self.preconditioner.apply(r)
                r = self.op.apply(x) - b
                return k + 1, x, r, jnp.linalg.norm(r)

            r0 = -b  # residual at x = 0
            k, x, _, r_nrm = jax.lax.while_loop(
                cond, body, (jnp.asarray(0), jnp.zeros_like(b), r0, r0_nrm)
            )
            return k, x, r_nrm, r0_nrm

        k, x, r_nrm, r0_nrm = run(b)
        r_nrm, r0_nrm = float(r_nrm), float(r0_nrm)
        converged = r_nrm / r0_nrm < p.rtol and r_nrm < p.atol
        if p.verbose >= 1:
            if converged:
                print(f"Solver converged after {int(k):5d} iterations")
                print(f"||r|| = {r_nrm:8.3e}, ||r||/||r_0|| = {r_nrm / r0_nrm:8.3e}")
            else:
                print(f"Solver failed to converge after {p.maxiter:5d} iterations")
        return SolveResult(x, converged, int(k), r_nrm)


class CGSolver:
    """Preconditioned conjugate gradients for the SPD lattice systems."""

    def __init__(self, op, preconditioner=None, params: IterativeSolverParameters = None):
        self.op = op
        self.preconditioner = preconditioner
        self.params = params or IterativeSolverParameters()

    def solve(self, b: jax.Array) -> SolveResult:
        p = self.params
        dot = lambda u, v: jnp.vdot(u, v)

        def precond(r):
            return self.preconditioner.apply(r) if self.preconditioner else r

        @jax.jit
        def run(b):
            x = jnp.zeros_like(b)
            r = b
            z = precond(r)
            d = z
            rz = dot(r, z)
            r0_nrm = jnp.linalg.norm(b)

            def cond(state):
                k, x, r, z, d, rz = state
                rn = jnp.linalg.norm(r)
                return (k < p.maxiter) & ~((rn / r0_nrm < p.rtol) & (rn < p.atol))

            def body(state):
                k, x, r, z, d, rz = state
                Ad = self.op.apply(d)
                alpha = rz / dot(d, Ad)
                x = x + alpha * d
                r = r - alpha * Ad
                z = precond(r)
                rz_new = dot(r, z)
                d = z + (rz_new / rz) * d
                return k + 1, x, r, z, d, rz_new

            k, x, r, *_ = jax.lax.while_loop(cond, body, (0, x, r, z, d, rz))
            return k, x, jnp.linalg.norm(r)

        k, x, rn = run(b)
        r0 = float(jnp.linalg.norm(b))
        return SolveResult(x, bool(float(rn) / r0 < p.rtol), int(k), float(rn))

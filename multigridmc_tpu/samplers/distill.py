"""Affine distillation of the MGMC coarse subtree.

Below the finest levels the MGMC W-cycle is an *op-count-bound* tail: the
sub-level visits are hundreds of tiny ops on 31^2-63^2 fields whose cost is
per-op (kernel launch) latency, not flops or bandwidth.  This module removes
that tail *structurally*.

The key observation: the recursive cycle (``src/sampler/multigridmc_sampler.cc:
103-130``) zero-initialises the coarse state at every recursion entry
(``multigridmc_sampler.cc:122``), and every operation below that point -
stochastic SOR/SSOR sweeps, Woodbury corrections, residual, restriction,
prolongation, the coarse Cholesky sample - is *affine* in ``(f, noise)`` with
Gaussian noise.  The entire subtree below level ``l`` is therefore an exact
affine-Gaussian map

    x_l = T f_l + N xi,   xi ~ N(0, I_K)   (K = total noise dims drawn below l)

so its conditional law is ``N(T f_l, C)`` with ``C = N^T N``.  Replacing the
recursion by

    x_l = T f_l + S xi',  xi' ~ N(0, I_n),  S = chol(C)

is *distributionally identical* (same Markov transition kernel, hence the same
exact stationary distribution N(Q^{-1} f, Q^{-1})), and costs two dense
matmuls per invocation instead of hundreds of latency-bound ops.

``T`` and ``N`` are computed once at setup by **basis propagation**: run the
subtree recursion on a batch of ``n + K`` basis vectors (the f-basis plus one
identity block per noise draw), reusing the production sweep/transfer code -
the propagation is the same program with the noise draws replaced by
deterministic identity injections, so exactness holds by construction.  The
same machinery with ``noise=False`` distils the *deterministic* multigrid
subtree (``src/preconditioner/multigrid_preconditioner.cc:74-101``) into a
single matrix for the preconditioner.

Applicability gate: storing T and S costs ``2 n^2`` floats and each invocation
costs ``2 C n^2`` MACs, so distillation is restricted to sub-levels with
``n <= MAX_N`` (4160: a 64^2-cell level; at the flagship bench this replaces
everything below the 127^2 level - 4 visits at 63^2, 8 at 31^2 and 8 coarse
Cholesky samples per step).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intergrid import prolongate_add, restrict
from ..ops.stencil import StencilOperator
from ..smoothers import sor_sweep

_HI = jax.lax.Precision.HIGHEST

#: largest sub-level vertex count distilled by default: storing T and S costs
#: 2 n^2 floats and each invocation 2 C n^2 MACs for C chains; 4160 admits the
#: 63^2/64^2-cell levels.  Not measured on the H100 yet: the crossover against
#: the composed subtree has to be scanned per cell.
MAX_N = 4160

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}
#: precision tier of the runtime T/S matmuls.  On a GPU, HIGH and DEFAULT run
#: float32 products in TF32 (10-bit mantissa); the stationary-variance bias of
#: the lower tiers has not been checked on the GPU, so the default is
#: HIGHEST (exact float32 products).
PRECISION = jax.lax.Precision.HIGHEST


def resolve_precision(precision) -> jax.lax.Precision:
    """A precision tier name, a ``jax.lax.Precision`` or None (the default)."""
    if precision is None:
        return PRECISION
    if isinstance(precision, str):
        if precision not in _PRECISIONS:
            raise ValueError(
                f"invalid distill precision '{precision}': expected one of "
                f"{sorted(_PRECISIONS)}")
        return _PRECISIONS[precision]
    return precision


# ------------------------------------------------------------------ sweep spec
def directed_sweeps(obj) -> List[Tuple[Tuple[int, ...], Optional[jax.Array]]]:
    """Flatten a smoother/sampler object into its per-apply directed sweep
    list ``[(colour order, B_bar or None), ...]`` (one noise draw per entry
    when sampling - cf. ``SORSampler.apply``/``SSORSampler.apply``)."""
    if hasattr(obj, "smoother"):  # SORSampler wraps one directed SORSmoother
        return directed_sweeps(obj.smoother) * obj.nsmooth
    if hasattr(obj, "order"):  # SORSmoother
        return [(obj.order, obj.B_bar)] * obj.nsmooth
    if hasattr(obj, "forward"):  # SSORSmoother / SSORSampler
        fwd = directed_sweeps(obj.forward)
        bwd = directed_sweeps(obj.backward)
        return (fwd + bwd) * obj.nsmooth
    raise TypeError(f"cannot extract sweeps from {type(obj).__name__}")


def _smoother_of(obj):
    while hasattr(obj, "smoother"):
        obj = obj.smoother
    if hasattr(obj, "forward"):
        return _smoother_of(obj.forward)
    return obj


# ------------------------------------------------------------------- distiller
class _Cursor:
    """Running offset into the stacked noise basis (rows n..n+K of the
    propagated batch); ``counting=True`` walks the structure without arrays."""

    def __init__(self, noise: bool, counting: bool, n_f: int = 0):
        self.noise = noise
        self.counting = counting
        self.off = n_f

    def field_noise(self, C, scale: jax.Array):
        """c += sqrt(D(2-omega)/omega) xi in basis form: the draw's identity
        block scaled per-vertex (cf. ``sor_sampler.cc:39-46``)."""
        if not self.noise:
            return C
        nb = int(np.prod(scale.shape))
        off = self.off
        self.off += nb
        if self.counting:
            return C
        sub = C[off:off + nb].reshape(nb, nb) + jnp.diag(scale.reshape(-1))
        return C.at[off:off + nb].set(sub.reshape((nb,) + scale.shape))

    def lowrank_noise(self, C, lowrank):
        """c += B Sigma^{-1/2} xi' in basis form (``sor_sampler.cc:48-56``)."""
        if not self.noise:
            return C
        m = lowrank.m
        off = self.off
        self.off += m
        if self.counting:
            return C
        scale = (1.0 / jnp.sqrt(lowrank.Sigma_diag)).reshape(
            (m,) + (1,) * (lowrank.B.ndim - 1)
        )
        return C.at[off:off + m].add((scale * lowrank.B).astype(C.dtype))

    def coarse_noise(self, g, nc: int):
        """xi + g of the coarse Cholesky sample (``cholesky_sampler.hh:50-66``)."""
        if not self.noise:
            return g
        off = self.off
        self.off += nc
        if self.counting:
            return g
        return g.at[off:off + nc].add(jnp.eye(nc, dtype=g.dtype))


class _SubtreeSpec:
    """Static description of the subtree below (and including) one level:
    per-level operators, directed pre/post sweep lists, the coarse sampler,
    and the cycle parameters - extracted from a MultigridMCSampler or
    MultigridPreconditioner slice."""

    def __init__(self, operators: Sequence[StencilOperator], presamplers,
                 postsamplers, coarse, cycle: int, coarse_scaling: float):
        self.operators = list(operators)
        self.pre = [directed_sweeps(p) for p in presamplers]
        self.post = [directed_sweeps(p) for p in postsamplers]
        self.smoothers = [_smoother_of(p) for p in presamplers]
        self.coarse = coarse  # DenseCholeskySampler/Solver or sweep sampler
        self.cycle = int(cycle)
        self.coarse_scaling = float(coarse_scaling)
        self.nlevel = len(self.operators)

    def _noise_scale(self, li: int) -> jax.Array:
        sm = self.smoothers[li]
        op = self.operators[li]
        return jnp.sqrt(op.diag_stencil() * (2.0 - sm.omega) / sm.omega)

    def _visit(self, li: int, sweeps, F, X, cursor: _Cursor):
        op = self.operators[li]
        sm = self.smoothers[li]
        for order, B_bar in sweeps:
            C = cursor.field_noise(F, self._noise_scale(li))
            if op.lowrank is not None:
                C = cursor.lowrank_noise(C, op.lowrank)
            if not cursor.counting:
                X = sor_sweep(op, sm.masks, sm.omega, order, C, X)
                if B_bar is not None:
                    bt = op.lowrank.bt(X)
                    X = X - jnp.tensordot(
                        bt, B_bar, axes=([bt.ndim - 1], [0]), precision=_HI
                    )
        return X

    def _coarse(self, F, cursor: _Cursor):
        op = self.operators[-1]
        from ..solvers.cholesky import DenseCholeskySolver

        if isinstance(self.coarse, DenseCholeskySolver):
            # deterministic solver: its L factors the stencil part only (the
            # low-rank term rides its Woodbury correction) - use its own
            # batched apply instead of mirroring the factor
            assert not cursor.noise, "Cholesky *solver* cannot inject noise"
            return None if cursor.counting else self.coarse.apply(F)
        if hasattr(self.coarse, "L"):  # DenseCholeskySampler: full-Q factor
            L = self.coarse.L
            nc = L.shape[0]
            if cursor.counting:
                cursor.coarse_noise(None, nc)
                return None
            Ff = F.reshape(-1, nc)
            g = jax.scipy.linalg.solve_triangular(L, Ff.T, lower=True).T
            g = cursor.coarse_noise(g, nc)
            y = jax.scipy.linalg.solve_triangular(L.T, g.T, lower=False).T
            return y.reshape(F.shape)
        # SSOR/SOR coarse sampler: sweeps from x = 0
        X = None if cursor.counting else jnp.zeros_like(F)
        return self._visit(
            self.nlevel - 1, directed_sweeps(self.coarse), F, X, cursor
        )

    def _sample(self, li: int, F, cursor: _Cursor):
        """Mirror of ``MultigridMCSampler._sample`` on a basis batch: every
        level inside the subtree is level > 0 in the original recursion, so
        it runs ``cycle`` iterations with carried state and zero init
        (``multigridmc_sampler.cc:103-130``)."""
        if li == self.nlevel - 1:
            return self._coarse(F, cursor)
        op = self.operators[li]
        dim = op.lattice.dim
        X = None if cursor.counting else jnp.zeros_like(F)
        for _ in range(self.cycle):
            X = self._visit(li, self.pre[li], F, X, cursor)
            if cursor.counting:
                Fc = None
            else:
                R = F - op.apply(X)
                Fc = restrict(R, dim=dim)
            Xc = self._sample(li + 1, Fc, cursor)
            if not cursor.counting:
                X = prolongate_add(self.coarse_scaling, Xc, X, dim=dim)
            X = self._visit(li, self.post[li], F, X, cursor)
        return X

    def count_noise(self, noise: bool) -> int:
        cursor = _Cursor(noise=noise, counting=True)
        self._sample(0, None, cursor)
        return cursor.off

    def propagate(self, noise: bool):
        """Basis propagation: returns the flat output batch ``X`` of shape
        ``(n + K, n)`` with rows = [f-basis | noise-basis] responses."""
        op = self.operators[0]
        vshape = op.vshape
        n = int(np.prod(vshape))
        K = self.count_noise(noise)
        dtype = op.coeffs.dtype

        def run():
            F0 = jnp.concatenate(
                [jnp.eye(n, dtype=dtype), jnp.zeros((K, n), dtype=dtype)]
            ).reshape((n + K,) + vshape)
            cursor = _Cursor(noise=noise, counting=False, n_f=n)
            X = self._sample(0, F0, cursor)
            assert cursor.off == n + K
            return X.reshape(n + K, n)

        return jax.jit(run)()


class DistilledSubtree:
    """Runtime affine-Gaussian replacement for one subtree invocation:
    ``apply(key, f) = f @ T + xi @ S^T`` with any leading batch dims."""

    def __init__(self, Tm: jax.Array, S_T: Optional[jax.Array],
                 vshape: Tuple[int, ...], level_info: dict, precision=None):
        self.Tm = Tm  # (n, n), row-vector convention x = f @ Tm
        self.S_T = S_T  # (n, n) upper factor, None for deterministic maps
        self.vshape = vshape
        self.n = Tm.shape[0]
        self.info = level_info
        self.precision = resolve_precision(precision)

    def apply(self, key, f: jax.Array) -> jax.Array:
        batch = f.shape[: f.ndim - len(self.vshape)]
        fl = f.reshape(batch + (self.n,))
        x = jnp.tensordot(fl, self.Tm, axes=([fl.ndim - 1], [0]),
                          precision=self.precision)
        if self.S_T is not None:
            xi = jax.random.normal(key, batch + (self.n,), dtype=f.dtype)
            x = x + jnp.tensordot(xi, self.S_T, axes=([xi.ndim - 1], [0]),
                                  precision=self.precision)
        return x.reshape(f.shape)

    def solve(self, b: jax.Array) -> jax.Array:
        """Deterministic map only (preconditioner subtree)."""
        return self.apply(None, b)


def _chol_psd(C: np.ndarray) -> np.ndarray:
    """Host float64 Cholesky of the (PSD, possibly f32-rounded) subtree
    covariance, with an escalating trace-scaled jitter fallback."""
    C = 0.5 * (C + C.T)
    base = np.trace(C) / C.shape[0]
    for j in (0.0, 1e-12, 1e-10, 1e-8, 1e-6):
        try:
            return np.linalg.cholesky(C + (j * base) * np.eye(C.shape[0]))
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError("subtree covariance not PSD after jitter")


def distill_subtree(
    operators: Sequence[StencilOperator],
    presamplers,
    postsamplers,
    coarse,
    cycle: int,
    coarse_scaling: float,
    *,
    noise: bool = True,
    precision=None,
) -> DistilledSubtree:
    """Distil the subtree spanned by ``operators`` (the ``[level:]`` slice of
    a hierarchy) into its exact affine-Gaussian map.  ``noise=False`` distils
    the deterministic multigrid cycle (preconditioner) instead."""
    spec = _SubtreeSpec(operators, presamplers, postsamplers, coarse,
                        cycle, coarse_scaling)
    op = operators[0]
    n = int(np.prod(op.vshape))
    X = spec.propagate(noise)
    Tm = X[:n]
    S_T = None
    if noise:
        Nm = X[n:]
        # C = N^T N: the exact output covariance of the subtree's noise stack
        C = jnp.matmul(Nm.T, Nm, precision=_HI)
        S = _chol_psd(np.asarray(C, dtype=np.float64))
        S_T = jnp.asarray(S.T, dtype=Tm.dtype)
    info = dict(n=n, K=int(X.shape[0]) - n, noise=noise)
    return DistilledSubtree(Tm, S_T, op.vshape, info, precision=precision)


def pick_distill_level(operators: Sequence[StencilOperator],
                       max_n: Optional[int] = None) -> Optional[int]:
    """Largest (finest) sub-level whose vertex count fits the distillation
    budget; None if no strict sub-level qualifies or the hierarchy is too
    shallow to benefit (distilling only the coarsest level would replace a
    single Cholesky sample with an equal-cost matmul)."""
    max_n = MAX_N if max_n is None else max_n
    for li in range(1, len(operators) - 1):
        if operators[li].lattice.nvertex <= max_n:
            return li
    return None

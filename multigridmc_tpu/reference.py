"""Plain float64 host reference of the multigrid building blocks.

The smoothers, the Woodbury correction, the transfers, the Galerkin hierarchy
and the deterministic V/W-cycle written directly from their matrix
definitions with numpy and ``scipy.sparse``, independent of the JAX code paths
(shifted stencil planes, tensor contractions, operator probing, distilled
subtrees).  Fields are ``(k, n)`` arrays: k right-hand sides or chains of n
vertices in the reference's lexicographic order.  Sparse storage keeps the
reference usable at deployment sizes (255^2 and 63^3 unknowns) as well as on
the small lattices of the tests.

Only the colour *pattern* (which vertices a sweep phase updates) is taken from
the program: it is part of the algorithm's definition, not of its arithmetic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from .ops.coloring import coloring_for
from .ops.stencil import StencilOperator

FORWARD = "forward"
BACKWARD = "backward"


def stencil_matrix(op: StencilOperator) -> sp.csr_matrix:
    """The stencil part ``A`` as a float64 sparse matrix: row i holds
    ``coeffs[k][i]`` at column ``i + offsets[k]`` for every neighbour inside
    the grid."""
    vshape = op.vshape
    n = int(np.prod(vshape))
    idx = np.arange(n).reshape(vshape)
    coeffs = np.asarray(op.coeffs, dtype=np.float64)
    rows, cols, vals = [], [], []
    for k, off in enumerate(op.offsets):
        src, tgt = [], []
        for o, m in zip(off, vshape):
            src.append(slice(max(0, -o), m - max(0, o)))
            tgt.append(slice(max(0, o), m - max(0, -o)))
        rows.append(idx[tuple(src)].ravel())
        cols.append(idx[tuple(tgt)].ravel())
        vals.append(coeffs[k][tuple(src)].ravel())
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n))
    return A.tocsr()


def restriction_1d(n_fine: int) -> sp.csr_matrix:
    """Full weighting on one axis: coarse vertex i gathers fine vertices
    ``2i, 2i+1, 2i+2`` with weights ``0.5, 1, 0.5`` (zero Dirichlet)."""
    n_coarse = n_fine // 2
    rows, cols, vals = [], [], []
    for i in range(n_coarse):
        for j, w in ((2 * i, 0.5), (2 * i + 1, 1.0), (2 * i + 2, 0.5)):
            if j < n_fine:
                rows.append(i)
                cols.append(j)
                vals.append(w)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_coarse, n_fine))


def restriction_matrix(vshape: Sequence[int]) -> sp.csr_matrix:
    """Tensor-product restriction ``R`` for a lexicographic grid (slowest axis
    first); prolongation is ``R^T``."""
    R = restriction_1d(vshape[0])
    for m in vshape[1:]:
        R = sp.kron(R, restriction_1d(m), format="csr")
    return R


class Level:
    """One level of the reference hierarchy: ``Q = A + B^T diag(1/Sigma) B``
    with ``B`` of shape ``(m, n)``, plus the colour masks of its sweeps."""

    def __init__(self, A: sp.csr_matrix, B: Optional[np.ndarray],
                 Sigma: Optional[np.ndarray], vshape: Tuple[int, ...],
                 masks: np.ndarray):
        self.A = A.tocsr()
        self.D = self.A.diagonal()
        self.B = B
        self.Sigma = Sigma
        self.vshape = tuple(vshape)
        self.masks = masks.reshape(masks.shape[0], -1).astype(bool)
        self.n_colors = masks.shape[0]

    def apply(self, x: np.ndarray) -> np.ndarray:
        """``Q x`` for ``x`` of shape ``(k, n)``."""
        y = (self.A @ x.T).T
        if self.B is not None:
            y = y + ((x @ self.B.T) / self.Sigma) @ self.B
        return y

    def dense(self) -> np.ndarray:
        Q = self.A.toarray()
        if self.B is not None:
            Q = Q + self.B.T @ np.diag(1.0 / self.Sigma) @ self.B
        return Q

    def order(self, direction: str) -> List[int]:
        order = list(range(self.n_colors))
        return order if direction == FORWARD else order[::-1]


def level_of(op: StencilOperator) -> Level:
    """Reference level of a program operator (its numbers in float64)."""
    B = Sigma = None
    if op.lowrank is not None:
        B = np.asarray(op.lowrank.B, dtype=np.float64).reshape(op.m_lowrank, -1)
        Sigma = np.asarray(op.lowrank.Sigma_diag, dtype=np.float64)
    masks = coloring_for(op.offsets, op.vshape).masks()
    return Level(stencil_matrix(op), B, Sigma, op.vshape, masks)


def hierarchy(op: StencilOperator, nlevel: int,
              offsets: Sequence[Sequence[Tuple[int, ...]]]) -> List[Level]:
    """Galerkin hierarchy by sparse triple products ``A_c = R A R^T`` and
    ``B_c = B R^T``.  ``offsets[l]`` is the stencil pattern of level l in the
    program (it fixes the colouring of that level's sweeps)."""
    levels = [level_of(op)]
    for li in range(1, nlevel):
        fine = levels[-1]
        R = restriction_matrix(fine.vshape)
        vshape = tuple(m // 2 for m in fine.vshape)
        A = (R @ fine.A @ R.T).tocsr()
        B = None if fine.B is None else (R @ fine.B.T).T
        masks = coloring_for(tuple(map(tuple, offsets[li])), vshape).masks()
        levels.append(Level(A, B, fine.Sigma, vshape, masks))
    return levels


def sor_sweep(level: Level, b: np.ndarray, x: np.ndarray, omega: float,
              direction: str) -> np.ndarray:
    """One multi-colour SOR sweep on the stencil part:
    ``x_i += omega (b - A x)_i / A_ii`` for the vertices of each colour."""
    x = x.copy()
    for c in level.order(direction):
        m = level.masks[c]
        r = b - (level.A @ x.T).T
        x[:, m] += omega * r[:, m] / level.D[m]
    return x


def splitting_solve(level: Level, V: np.ndarray, omega: float,
                    direction: str) -> np.ndarray:
    """Solve ``M y = v`` with ``M = D/omega + L_c`` (the colour-ordered lower
    part) by forward substitution over colours; rows of ``V`` are right-hand
    sides."""
    Y = np.zeros_like(V)
    off = level.A - sp.diags(level.D)
    for c in level.order(direction):
        m = level.masks[c]
        Y[:, m] = omega * (V - (off @ Y.T).T)[:, m] / level.D[m]
    return Y


def woodbury_factor(level: Level, omega: float, direction: str) -> np.ndarray:
    """``B_bar = M^{-1} B^T (Sigma + B M^{-1} B^T)^{-1}`` of shape ``(m, n)``:
    the sweep's low-rank correction is ``x <- x - (B x) B_bar``."""
    Y = splitting_solve(level, level.B, omega, direction)  # rows: M^{-1} b_k
    S = np.diag(level.Sigma) + level.B @ Y.T
    return np.linalg.solve(S.T, Y)


def smooth(level: Level, b: np.ndarray, x: np.ndarray, omega: float,
           direction: str, B_bar: Optional[np.ndarray] = None) -> np.ndarray:
    """One SOR sweep followed by the Woodbury correction of a posterior."""
    x = sor_sweep(level, b, x, omega, direction)
    if level.B is not None:
        if B_bar is None:
            B_bar = woodbury_factor(level, omega, direction)
        x = x - (x @ level.B.T) @ B_bar
    return x


def ssor(level: Level, b: np.ndarray, x: np.ndarray, omega: float) -> np.ndarray:
    x = smooth(level, b, x, omega, FORWARD)
    return smooth(level, b, x, omega, BACKWARD)


def multigrid_cycle(levels: Sequence[Level], b: np.ndarray, *, omega: float = 1.0,
                    cycle: int = 1, coarse_scaling: float = 1.0,
                    smoother: str = "SOR") -> np.ndarray:
    """One deterministic multigrid V (cycle=1) or W (cycle=2) cycle from a
    zero initial guess, with an exact coarsest-level solve."""
    smoother = smoother.upper()
    coarse = np.linalg.cholesky(levels[-1].dense())
    factors = {}

    def sweep(li, rhs, x, direction):
        if smoother == "SSOR":
            return ssor(levels[li], rhs, x, omega)
        lv = levels[li]
        if lv.B is not None and (li, direction) not in factors:
            factors[li, direction] = woodbury_factor(lv, omega, direction)
        return smooth(lv, rhs, x, omega, direction, factors.get((li, direction)))

    def solve(li, rhs):
        if li == len(levels) - 1:
            y = np.linalg.solve(coarse, rhs.T)
            return np.linalg.solve(coarse.T, y).T
        lv = levels[li]
        R = restriction_matrix(lv.vshape)
        x = np.zeros_like(rhs)
        for _ in range(cycle if li > 0 else 1):
            x = sweep(li, rhs, x, FORWARD)
            r = rhs - lv.apply(x)
            xc = solve(li + 1, (R @ r.T).T)
            x = x + coarse_scaling * (R.T @ xc.T).T
            x = sweep(li, rhs, x, BACKWARD)
        return x

    return solve(0, b)


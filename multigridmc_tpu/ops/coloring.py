"""Lattice colorings that turn sequential SOR/Gibbs sweeps into parallel ones.

The reference's hot loop is an inherently sequential lexicographic sweep over CSR
rows (``src/smoother/sor_smoother.cc:56-78``).  Here we replace the
lexicographic order with a *multi-colour* order: vertices are partitioned into
colours such that no two vertices of the same colour are coupled by the stencil;
each colour is then updated in one fully parallel masked stencil application.
Any fixed scan order yields a valid Gauss-Seidel/SOR splitting (and a valid
Gibbs sampler with exact stationary distribution - Fox & Parker 2017); only the
convergence *rate* differs, which the statistical acceptance tests are
insensitive to.

Colour schemes (all linear-mod colourings ``c(i) = sum_d k_d i_d mod K``):

* axis-only stencils (5/7-point FD) ............ red-black, K = 2
* 3^d box stencils (FEM, coarsened FD) ......... K = 2^d with k = (1, 2, 4)
* 2d diamond radius 2 (13-point biharmonic) .... K = 5 with k = (1, 2)
* generic box radius s ......................... (s+1)^d block colouring

Each scheme is verified against the offset set at construction time.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Coloring:
    """A colour field over the vertex grid plus the number of colours."""

    n_colors: int
    #: integer colour per vertex, shape = vshape
    field: np.ndarray
    #: per-axis weights of the linear-mod colouring c = sum_d w_d i_d mod K
    #: (array-axis order); lets kernels regenerate the colour field from iota
    weights: tuple = ()

    def masks(self, dtype=np.float64) -> np.ndarray:
        """One-hot colour masks, shape (n_colors, *vshape)."""
        return np.stack([(self.field == c).astype(dtype) for c in range(self.n_colors)])


def _linear_coloring(vshape, weights, K) -> np.ndarray:
    grids = np.meshgrid(*[np.arange(m) for m in vshape], indexing="ij")
    c = np.zeros(vshape, dtype=np.int64)
    for g, w in zip(grids, weights):
        c += w * g
    return c % K


def _valid(offsets, weights, K) -> bool:
    """A linear-mod colouring is proper iff no non-zero offset maps to 0 mod K."""
    for off in offsets:
        if all(o == 0 for o in off):
            continue
        if sum(w * o for w, o in zip(weights, off)) % K == 0:
            return False
    return True


def coloring_for(offsets: Tuple[Tuple[int, ...], ...], vshape: Tuple[int, ...]) -> Coloring:
    """Pick the cheapest valid colouring for a stencil's offset set."""
    dim = len(vshape)
    candidates = []
    # red-black
    candidates.append(((1,) * dim, 2))
    # 2^d block colouring for 3^d box stencils (axis order: slowest axis first)
    candidates.append((tuple(2**a for a in range(dim)), 2**dim))
    if dim == 2:
        # 5-colouring for the 13-point diamond stencil
        candidates.append(((2, 1), 5))
        candidates.append(((1, 2), 5))
    # generic block colourings of increasing size
    s = max(max(abs(o) for o in off) for off in offsets)
    weights = []
    K = 1
    for _ in range(dim):
        weights.append(K)
        K *= s + 1
    candidates.append((tuple(reversed(weights)), K))

    candidates.sort(key=lambda wk: wk[1])
    for weights, K in candidates:
        if _valid(offsets, weights, K):
            return Coloring(
                n_colors=K,
                field=_linear_coloring(vshape, weights, K),
                weights=tuple(weights),
            )
    raise ValueError(f"no valid colouring found for offsets {offsets}")

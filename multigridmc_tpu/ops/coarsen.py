"""Galerkin coarsening of stencil operators by probing.

The reference computes the coarse-level operator as a sparse triple product
``A_c = R A R^T`` (``src/linear_operator/linear_operator.cc:10-23``).  Here we
never materialise sparse matrices; instead we exploit that ``R A P`` is itself a
local stencil operator: with d-linear transfer (reach 1 fine vertex) and a fine
stencil of reach ``s`` (Chebyshev radius), the coarse stencil has reach
``s_c = (s + 2) // 2`` coarse vertices.

The coarse coefficients are extracted *exactly* with ``(2 s_c + 1)^d`` probing
vectors: probe ``v_r`` is the indicator of the sub-lattice ``{ j : j = r mod p }``
with period ``p = 2 s_c + 1`` per dimension.  Because two coarse vertices of the
same residue class are at least ``p > 2 s_c`` apart, their columns never overlap
within one stencil row, so

    ``(R A P v_r)[j] = A_c[j, j + o]``   where ``o = (r - j) mod p`` mapped to [-s_c, s_c].

This keeps Galerkin coarsening a pure composition of the (already verified)
restrict / apply / prolongate primitives - the identity with natively assembled
coarse operators (cf. ``src/intergrid/test_intergrid.hh:179-207``) holds by
construction of the probes.

The low-rank factor coarsens column-wise: ``B_c = R B``, ``Sigma_c = Sigma``
(``linear_operator.cc:10-23``).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .intergrid import prolongate, restrict
from .stencil import LowRank, StencilOperator


def _stencil_reach(offsets) -> int:
    return max(max(abs(o) for o in off) for off in offsets)


def galerkin_coarsen(op: StencilOperator) -> StencilOperator:
    """Coarsen ``A -> R A P`` (and ``B -> R B``) onto the next-coarser lattice."""
    fine = op.lattice
    coarse = fine.coarsen()
    dim = fine.dim
    s_c = (_stencil_reach(op.offsets) + 2) // 2
    p = 2 * s_c + 1

    cvshape = coarse.vshape
    dtype = op.coeffs.dtype

    # Build all p^d probe vectors on the coarse grid (one-hot residue classes).
    residues = list(itertools.product(range(p), repeat=dim))
    probes = []
    idx_grids = np.meshgrid(*[np.arange(m) for m in cvshape], indexing="ij")
    for r in residues:
        mask = np.ones(cvshape, dtype=bool)
        for ax in range(dim):
            mask &= (idx_grids[ax] % p) == r[ax]
        probes.append(mask.astype(np.float64))
    probes = jnp.asarray(np.stack(probes), dtype=dtype)  # (p^d, *cvshape)

    def rap(v):
        return restrict(op.apply_stencil(prolongate(v, fine.vshape)))

    # jit: one dispatch for all probes instead of eager per-primitive
    # dispatches
    W = jax.jit(jax.vmap(rap))(probes)  # (p^d, *cvshape)

    # Extract coefficients: coeff_o[j] = W[class((j + o) mod p)][j].
    # W has shape (p^d, *cvshape); select along axis 0 per element.
    offsets = sorted(itertools.product(range(-s_c, s_c + 1), repeat=dim))
    cls_all = []
    for off in offsets:
        cls = np.zeros(cvshape, dtype=np.int64)
        for ax in range(dim):
            cls = cls * p + (idx_grids[ax] + off[ax]) % p
        cls_all.append(cls)
    cls_all = jnp.asarray(np.stack(cls_all))  # (n_off, *cvshape)

    @jax.jit
    def extract(W, cls_all):
        return jax.vmap(
            lambda cls: jnp.take_along_axis(W, cls[None], axis=0)[0]
        )(cls_all)

    coeffs = extract(W, cls_all)

    lowrank = None
    if op.lowrank is not None:
        B_c = jax.vmap(restrict)(op.lowrank.B)
        lowrank = LowRank(B=B_c, Sigma_diag=op.lowrank.Sigma_diag)

    return StencilOperator(
        coeffs=coeffs, offsets=tuple(offsets), lattice=coarse, lowrank=lowrank
    ).normalized()

"""Intergrid transfer operators: d-linear prolongation and its transpose.

Counterpart of ``src/intergrid/intergrid_operator.hh:43-161`` and
``intergrid_operator_linear.cc:13-30``.  The reference stores an explicit 3^d
stencil with indirection arrays; here both transfers are expressed as
*tensor-product matrix contractions*: per dimension a banded ``(n_c, n_f)``
matrix ``R1`` with row i = {0.5, 1, 0.5} centred at fine index ``2 i + 1``
(cf. ``Lattice1d::fine_vertex_idx``, ``lattice1d.hh:145-148``), so

    restrict    f_c = R1 . r . R1^T        (one contraction per dimension)
    prolongate  x_f = R1^T . x_c . R1

Each contraction is one matmul that performs the {0.5, 1, 0.5} stencil *and*
the stride-2 subsample/interleave in one op - no strided slicing, no 3^d
shifted copies.  Restriction is the exact
transpose of prolongation by construction (same ``R1`` per dimension), as
verified by the adjointness test (cf. ``src/intergrid/test_intergrid.hh:155-171``).

The matrix entries (1, 0.5) and their per-dim products are exact powers of two,
so contraction at ``Precision.HIGHEST`` loses no accuracy vs the shift-add
formulation (only the summation order differs).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _restrict_matrix_1d(n_fine: int, dtype_name: str) -> np.ndarray:
    """Banded ``(n_coarse, n_fine)`` full-weighting matrix for one dimension.

    Row i holds weights {0.5, 1, 0.5} at fine indices ``2 i + 1 + {-1, 0, 1}``
    (out-of-range entries dropped: zero-Dirichlet boundary, matching the
    stencil gather in ``intergrid_operator.hh:74-88``).  Returned as a host
    numpy constant (safe to cache across jit traces).
    """
    n_coarse = len(range(1, n_fine, 2))
    R = np.zeros((n_coarse, n_fine), dtype=dtype_name)
    for i in range(n_coarse):
        c = 2 * i + 1
        R[i, c] = 1.0
        if c - 1 >= 0:
            R[i, c - 1] = 0.5
        if c + 1 < n_fine:
            R[i, c + 1] = 0.5
    return R


def _contract_last_dims(x: jax.Array, mats) -> jax.Array:
    """Contract each of the trailing ``len(mats)`` axes of x with its matrix."""
    dim = len(mats)
    for d, M in enumerate(mats):
        ax = x.ndim - dim + d
        x = jnp.moveaxis(x, ax, -1)
        x = jax.lax.dot_general(
            x, jnp.asarray(M), (((x.ndim - 1,), (1,)), ((), ())), precision=_HI
        )
        x = jnp.moveaxis(x, -1, ax)
    return x


def prolongate(x_coarse: jax.Array, fine_vshape: Tuple[int, ...]) -> jax.Array:
    """``P x_c``: d-linear interpolation from the coarse to the fine grid.

    Injects coarse values at fine positions ``2 i + 1`` and spreads them with
    the tensor-product {0.5, 1, 0.5} stencil (cf. ``intergrid_operator.hh:106-120``
    and the linear weights ``intergrid_operator_linear.cc:13-30``) - realised as
    one ``R1^T`` contraction per dimension.
    """
    dim = len(fine_vshape)
    name = jnp.dtype(x_coarse.dtype).name
    mats = [_restrict_matrix_1d(fine_vshape[d], name).T for d in range(dim)]
    return _contract_last_dims(x_coarse, mats)


def restrict(x_fine: jax.Array, dim: int | None = None) -> jax.Array:
    """``R x_f`` with ``R = P^T``: full-weighting gather onto coarse vertices.

    ``(R x)[i] = sum_off w(off) x[2 i + 1 + off]`` per dimension, matching the
    stencil gather in ``intergrid_operator.hh:74-88``.
    """
    dim = x_fine.ndim if dim is None else dim
    name = jnp.dtype(x_fine.dtype).name
    mats = [
        _restrict_matrix_1d(x_fine.shape[x_fine.ndim - dim + d], name)
        for d in range(dim)
    ]
    return _contract_last_dims(x_fine, mats)


def prolongate_add(
    alpha: float, x_coarse: jax.Array, x_fine: jax.Array, dim: int | None = None
) -> jax.Array:
    """``x_f + alpha * P x_c`` (cf. ``intergrid_operator.hh:106-120``)."""
    dim = x_fine.ndim if dim is None else dim
    return x_fine + alpha * prolongate(x_coarse, x_fine.shape[x_fine.ndim - dim :])
